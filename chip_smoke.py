"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--k1-crossover-sweep]

Builds the port's Hopper kernels from ``src/repro_torch/kernels/csrc``
and holds each one against its plain PyTorch version at the shapes its
path gives it. Then, at the paper's full widths (V=100 000, w=300,
N=5000, 10 queries of 19-43 words, n_iter=15), it drives each path:

- staged exact top-k search, ``WmdEngine.search(k=10, prune="rwmd")``
  and ``query_batch`` (kernels K2 and K1), checked against the
  exhaustive top-k;
- the paper's one-query workload, ``one_to_many`` with all five impls
  (``impl="kernel"`` runs K3 and K4), checked against ``impl="dense"``,
  and ``many_to_many`` against the per-query loop;
- the fused step ``ops.sddmm_spmm_step`` (K5) on the widest paper query
  and a 200-word one, and looped as a solve, checked against the sparse
  solver's iteration;
- on the reference benchmark's near-duplicate corpus at the same widths
  (4992 documents, 4 queries), the IVF cascade ``search(prune="ivf+...",
  nprobe=...)`` (K2s and K1) and ``mode="refine"``, checked against the
  exhaustive top-k, and ``append_docs`` checked against a rebuild;
- the adaptive and bf16 solve: K1 and K4 with ``tol``/``check_every``/
  ``resmask`` and bf16 operands, K3 with bf16 operands, each against its
  plain version; on the near-duplicate corpus ``search`` under ``tol``
  (fig10's operating points, ``scope="query"`` and ``"chunk"``, fp32, log
  and bf16) checked against the exhaustive top-k under the same ``tol``
  and against the fixed-iteration top-k; and the one-query kernel path
  under ``tol`` and bf16 against the sparse solver;
- the block-sparse SDDMM ``ops.bsr_sddmm`` (K6) on the paper corpus's
  doc matrix at 128 x 128 and 64 x 64 tiles, and K1 on a (v_r, L) tile
  over the shared-memory limit;
- K1 at the main path's chunk and the paper's widest with its fixed cost
  (``n_iter`` 0 and 1) and the inert docs' share, and in every tile
  class up to 64 x 64; K2 beside cuBLAS SGEMM of the same product (also
  at 128 queries, one launch); and K1's shared-memory against its
  device-memory variant on each side of the tile where ``auto`` switches
  between them (``--k1-crossover-sweep``: across eight tiles from 96 x 28
  to 192 x 192);
- the einsum engine ``WmdEngine(impl="sparse")``: search and
  ``query_batch`` against its exhaustive top-10 and the kernel engine's
  distances, ``warm_start`` on the near-duplicate corpus, the K-column
  cache under fig15's Zipfian traffic (cache-on equals cache-off bit for
  bit, hit rate), and ``many_to_many`` / ``search`` with their defaults;
- the serving runtime, ``ServingRuntime`` driven open-loop by
  ``run_open_loop`` over the kernel engine (log, lam=10, the runtime's
  ``"ivf+wcd+rwmd"``): K2s against its plain version at the inputs of a
  one-query cascade search of the paper corpus (what a served request
  runs), capacity C from back-to-back 8-query searches and C1 from
  one-query searches, every tier through the runtime (K1, K2 and K2s
  launches per dispatch), 64 requests at 0.25 C1 (light load: every
  response exact, equal to the replay of its batch and to the exhaustive
  top-10) and 256 at 2 C (every request resolves, load degrades or is
  rejected, exact responses equal their replay and the exhaustive
  top-10, rwmd-tier bounds admissible), injected transients, latency and
  poison at 0.25 C1 (exactly the poisoned requests fail), fp32 lam=10's
  ``lam_underflow`` through the guard, the einsum engine under the
  runtime's default K-column cache on fig15's whole stream (every
  response equals the cache-off engine's search of its batch), and a
  profiled window at 0.25 C (the card's idle share, device time per
  request, the rank stage's host time). A serving phase without
  injected faults fails on any ``internal`` or ``retries_exhausted``
  response;
- the sharded engine and the distributed solver, every shard on the
  card(s) ``corpus_mesh`` deals it to (one card: every shard on it, no
  shard ever on the CPU): ``ShardedWmdEngine`` over 1, 2 and 4 shards of
  the paper corpus (``"ivf+wcd+rwmd"`` at ``nprobe=None`` and ``"rwmd"``,
  log, lam=10; one shard bit for bit the single engine's result, more
  shards equal to it under the near-tie rule; K1, K2 and K2s launches per
  shard and summed; exactly one ``all_gather`` per merge; timings beside
  the single engine's; the card's idle share), snapshots and recovery on
  two shards (a raw shard exception and a hang give honest partial
  results, ``restore_shard`` is bit-exact, a stale snapshot is refused),
  the serving runtime over two shards (64 requests at 0.25 of its C1,
  every response exact with full coverage and equal to the exhaustive
  top-10; a crashed shard gives ``partial`` responses until restored),
  and the distributed sparse solver (fixed and adaptive, vshard on and
  off) over a (2, 4) mesh of positions at the widest paper query and all
  5000 documents, and the dense one with N cut to 512, against the
  single-device solvers at 1e-3. Outside the runs that inject faults,
  every sharded search must cover every shard;
- the LM decode server: the reduced models of all ten archs on the card
  against the host, then qwen2_moe_a2_7b, granite_3_2b, rwkv6_3b,
  zamba2_7b, qwen2_5_14b and phi3_medium_14b at full width and depth, and
  chameleon_34b, nemotron_4_340b and qwen3_moe_235b_a22b at full width
  and the depth whose fp32 weights fit the card (serve steps, prefill
  against decode);
- training: the reduced granite and qwen2_moe (Sinkhorn router) train
  step on the card against the host and checkpoint save / restore /
  resume against the uninterrupted run; granite_3_2b at full width
  through ``launch/train.py``'s ``run`` (6 steps at B=8, T=1024, remat,
  one profiled step, the model-FLOP bound); the MoE training example
  (``examples/torch_train_moe_sinkhorn.py``) for 100 steps, its ce
  falling, both routers' drop fractions;
- expert parallelism and the dry-run: qwen2_moe_a2_7b at full width with
  its experts over a (data=2, model=4) mesh of positions on the card
  (``Transformer`` / ``make_serve_step`` with ``mesh=``): 32 serve steps
  against the same model without a mesh (top-k, no drops; one ``psum``
  per MoE layer a step) and the Sinkhorn router's per-shard semantics;
  the reduced qwen2_moe's weights on the host serving over positions on
  the card (expert slices copied once, then held: no copy at the second
  step, logits equal to the per-call copies' bit for bit);
  the reduced qwen2_moe train step with a mesh on the card against the
  host and against the non-EP gradients; the dry-run's whole meta sweep
  (``repro_torch.launch.dryrun``: 10 archs x 4 shapes x 2 meshes, the
  long_500k cells of the attention archs skipped) and its FLOP counter
  against the measured granite_3_2b train step.

Each path runs once with the launch counts set to 0 just before it and
read just after. Prints one JSON object per phase; the line before the
last lists every kernel with its launches on its path, error, time,
plain time and bound; the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero without that last
line. It needs a CUDA device and the CUDA toolkit (``nvcc``), and imports
nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.paper_wmd import CONFIG  # noqa: E402
from repro_torch.core.index import (WmdEngine, _compute_kq,  # noqa: E402
                                    _gather_g, build_index,
                                    default_n_clusters)
from repro_torch.core import (append_docs, many_to_many,  # noqa: E402
                              one_to_many)
from repro_torch.core.prune import CascadePruner  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    sharded_inputs, sinkhorn_wmd_dense_distributed,
    sinkhorn_wmd_sparse_distributed)
from repro_torch.core.shard_index import (  # noqa: E402
    ShardedWmdEngine, append_docs_sharded, restore_shard, shard_corpus)
from repro_torch.core.sinkhorn import (LamUnderflowError,  # noqa: E402
                                       select_support)
from repro_torch.core.sinkhorn_sparse import (_iterate,  # noqa: E402
                                              gather_columns,
                                              precompute_sparse,
                                              sinkhorn_wmd_sparse)
from repro_torch.core.sparse import (PaddedDocs,  # noqa: E402
                                     padded_docs_to_dense)
from repro_torch.data.corpus import (dedup_corpus, make_corpus,  # noqa: E402
                                     paper_corpus, zipf_queries)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.data.pipeline import wmd_request_stream  # noqa: E402
from repro_torch.runtime.serving import (FaultInjector,  # noqa: E402
                                         ServeConfig, ServingRuntime,
                                         default_tiers, poisson_arrivals,
                                         run_open_loop)
from repro_torch.runtime.sharding import (  # noqa: E402
    collective_counts, corpus_mesh, count_collectives, make_mesh)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import (make_prefill,  # noqa: E402
                                      make_serve_step)
from repro_torch.models.moe import (moe_apply_ep,  # noqa: E402
                                    moe_dropped_fraction, slice_copies)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.models.model import (TrainHParams,  # noqa: E402
                                      make_train_step)
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at_step  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.launch import dryrun as dryrun_cli  # noqa: E402
from repro_torch.runtime.analysis import stacked_cost  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM rate and fp32 FFMA
# rate outside the tensor cores, both at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# K2: the kernel sums the w-long dot product in another order than the
# plain version's cuBLAS GEMM. The error sits in the squared distance
# |a|^2+|b|^2-2a.b, at a few ulps of |a|^2+|b|^2 (~600 at w=300), so it is
# held there: |got^2 - want^2| <= K2_SQ_RTOL * (|a_q|^2max + |b_v|^2).
# On a distance of ~25 that is ~1e-4; where a query word is the vocabulary
# word itself (d ~ 0) the sqrt turns the same residue into ~2e-2.
K2_SQ_RTOL = 1e-5
# K1: sums over v_r and L run in another order, and 15 iterations of
# the scaling fixed point carry the ulp differences into the distance
K1_RTOL, K1_ATOL = 1e-4, 1e-4
# K1 tiles of each class up to 64 x 64 that no paper chunk has, where
# phase k1_tiles times the warp-per-tile kernel (v_r and L on each side
# of 32)
K1_CLASSES = ((32, 32), (24, 56), (56, 24), (48, 48), (64, 64))
# K3: ref.K3_SQ_RTOL and ref.K3_ULP (ref.hold_cdist_exp holds it)
# K4: tests/test_kernels.py's tolerance for the reference kernel
K4_RTOL, K4_ATOL = 5e-5, 5e-5
# K5: one iteration, sums in another order (tests/test_kernels.py's)
K5_RTOL, K5_ATOL = 1e-5, 1e-5
# K5's subnormal edges: tests/test_torch_kernels.py's "subnormal" and
# "subnormal_live" inputs (v_r, N, L) and the doc and slot whose G column
# is subnormal; the kernel must give no NaN there and equal its plain
# version, which takes a subnormal t as not positive (w = 0)
K5_SUBNORMAL_SHAPE = (23, 64, 28)
K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT = 1, 9
# one_to_many: sparse, sparse_unfused and kernel against dense at
# tests/test_sinkhorn.py's tolerance. The kernel impl makes M with K3,
# which sums a.b in another order than the dense impl's cuBLAS GEMM: at
# exact word matches that leaves up to ~2e-2 of distance (P1). The kernel
# impl (and its log domain, against the sparse solver's) is held at the
# gap that alone leaves at w=300: 3.6e-4 (2.4e-4 log) measured on an H100
# (ROADMAP queue 3, P1). The kernel path fed the plain K is held at
# OTM_RTOL
OTM_RTOL, OTM_ATOL = 2e-4, 2e-4
P1_RTOL = 4e-4
# timed one_to_many calls per impl (dense: DENSE_REPS) and the docs the
# dense_stabilized impl takes: its (v_r, V, N) temporaries are ~2.4 GB
# at 256 docs, ~50 GB at all 5000
OTM_REPS, DENSE_REPS, STAB_DOCS = 10, 3, 256
# dense_stabilized and dense reach one fixed point from different starts:
# they are compared after this many iterations (they differ by ~1e-2 at 15)
STAB_ITERS = 200
# many_to_many: the batched engine against the per-query loop, within the
# reference's own batched-vs-looped spread (ROADMAP queue 3, R2)
M2M_RTOL = 1e-3
# staged vs exhaustive distances: the same per-doc solve on other ELL
# trims (pad slots are exactly inert), so agreement is at fp32 rounding
E2E_RTOL = 1e-5
# timed end-to-end calls per configuration (after one warm-up and the
# counted run)
E2E_REPS = 15
# spin-kernel cycles that hold the stream while time_ms enqueues its
# launches (~25 ms at the H100's 1.98 GHz boost clock)
HOLD_CYCLES = 50_000_000
# the cascade phases: the reference benchmark's near-duplicate corpus at
# the paper's widths (312 base documents x 16 variants = 4992 documents of
# 19-43 words, 4 queries), top-10; the append phase builds on the first
# APPEND_BASE documents and appends the rest
DEDUP_DOCS, TOP_K, APPEND_BASE = 5000, 10, 4480
CASCADE_SPECS = ("ivf", "ivf+wcd", "ivf+rwmd", "ivf+wcd+rwmd",
                 "ivf+pivot+wcd+rwmd", "ivf+pivot+rwmd")
NPROBES = (1, 4, 16, None)
REFINE_FACTORS = (1, 2, 4)
# the refine phases rank by the pivot cascade, as the serve CLI's example
REFINE_PRUNE = "ivf+pivot+wcd+rwmd"
# the adaptive solve's operating points: fig10's (lam=0.25, tol=3e-2, two
# iterations per check, the paper's 15 as the cap) and its per-query
# scope points (lam=1, and lam=10 in the log domain, tol=1e-2, cap 60)
# (benchmarks/fig10_solve_adaptive.py)
FIG10 = dict(lam=0.25, n_iter=15, tol=3e-2, check_every=2)
PQ = dict(lam=1.0, n_iter=60, tol=1e-2, check_every=2)
PQ_LOG = dict(lam=CONFIG.lam, n_iter=60, tol=1e-2, check_every=2,
              precision="log")
# fig10's bf16 tolerance against the fixed fp32 top-10: every doc a bf16
# search returns lies within it of the fp32 10th distance
BF16_RTOL = 5e-2
# ... and fig10 holds every bf16 distance to fp32 at BF16_RTOL too, but
# that tolerance was set at w=64: the bf16 operands of the K block's
# w-long product move M by more at w=300, where the reference's own bf16
# engine differs from fp32 by 7.4% (ROADMAP queue 3, R6), and in phase
# adaptive the port's bf16 and bf16+log engines by up to 7.9% (on an H100
# at 700 W). Distances are held at that size, rounded up
BF16_W300_RTOL = 1e-1
# K1 (K4) exits per document, the sparse solver and the reference's
# kernel for all documents (a block) at once: a converged document stops
# earlier, which moves its distance by up to 4.8e-2 relative on the CPU
# dedup fixtures (ROADMAP queue 3, P3)
P3_RTOL = 5e-2
# the one-query kernel path with bf16 operands against the sparse solver:
# K3 and cuBLAS sum M in another order (P1; 4.2e-4 measured on the card),
# held at the reference's own spread R2
BF16_P1_RTOL = 1e-3
# the einsum engine against the kernel engine: tests/test_engine.py's
# test_batched_matches_per_query_oracle holds the reference's two impls
# at rtol = atol = 5e-4
EINSUM_RTOL = 5e-4
# the K-column cache phase: fig15's capacity and prune spec
KCACHE_SLOTS = 512
KCACHE_PRUNE = "ivf+wcd+rwmd"
# the serving phases: the runtime's defaults (ServeConfig) but for
# max_batch, over the runtime's default prune spec, open-loop Poisson
# arrivals. Capacity C is SERVE_BATCH over the median of E2E_REPS
# back-to-back searches of SERVE_BATCH stream queries; C1 the same with
# one query a search, the batch the coalescer forms at light load (its
# 10 ms window is shorter than the gap between arrivals). The cascade
# costs about the same per search at any batch (PERF.md §5), so the
# runtime sustains about C1, not C: the exactness, fault and cache runs
# offer SERVE_LOW * C1 (light load), the load run SERVE_HIGH * C, and the
# profiled window SERVE_LOW * C (saturated)
SERVE_BATCH = 8
SERVE_PRUNE = ServeConfig.prune
SERVE_LOW, SERVE_HIGH = 0.25, 2.0
# requests per run: the load run, the light runs, each tier's warm-up
# through the runtime (one runtime per tier), the profiled window; the
# cache run serves fig15's whole stream (128 queries)
SERVE_REQUESTS, SERVE_LIGHT, SERVE_WARM, SERVE_PROFILED = 256, 64, 8, 64
SERVE_FAULTS = dict(transient_rate=0.2, poison_rate=0.05, latency_rate=0.1,
                    latency_s=0.05, seed=7)
# codes that mean a dispatch failed on the card: a serving phase without
# injected faults raises on any of them
SERVE_FAILED = ("internal", "retries_exhausted")
# the sharded phases: shard counts on corpus_mesh(S) (round-robin over the
# visible cards), the prune specs each S runs (the cascade at
# nprobe=None, and the full RWMD sweep), the hang a shard_snapshot run
# injects is longer than SHARD_TIMEOUT_S, and the serve_shards crash and
# recovery runs take SHARD_SERVE_FAULT requests each
SHARD_COUNTS = (1, 2, 4)
SHARD_PRUNES = ("ivf+wcd+rwmd", "rwmd")
SHARD_TIMEOUT_S = 0.5
SHARD_SERVE_FAULT = 16
SHARD_SNAPSHOT_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_shards"
# the distributed phase: a (2, 4) ("data", "model") mesh of positions,
# lam=1 (lam=10 underflows fp32 K at w=300), held against the
# single-device sparse solver at the reference's own tolerance
# (tests/test_distributed.py: abs 1e-3); the dense solver at N cut to
# DIST_DENSE_DOCS: its (V, N) temporaries at all 5000 documents are
# ~2 GB an iteration; the adaptive runs at PQ's tol and check_every
DIST_MESH = ((2, 4), ("data", "model"))
DIST_ATOL = 1e-3
DIST_DENSE_DOCS = 512
DIST_POISON_LAM = 500.0
# LM decode (no hand-written kernel: the reference's LM path reaches no
# Pallas kernel). The reduced configs on the card against the host (both
# routers of the MoE, the SSM and the hybrid), then qwen2_moe_a2_7b,
# granite_3_2b, rwkv6_3b and zamba2_7b at full width and depth in fp32, the
# reference serve_lm's dtype: LM_BATCH sequences, LM_STEPS greedy steps,
# p50/p99 over all but the first two (as serve_lm), a profiled window of
# LM_PROFILE_STEPS. Prefill against token-by-token decode at the
# reference's 2e-3 (tests/test_arch_smoke.py), over LM_PREFILL_LEN
# positions, or LM_SSM_PREFILL_LEN for the ssm and hybrid families: two of
# their 128-token chunks, so the state carries between chunks at full width
LM_SMALL = (("granite_3_2b", None), ("qwen2_moe_a2_7b", "sinkhorn"),
            ("qwen2_moe_a2_7b", "topk"), ("musicgen_large", None),
            ("rwkv6_3b", None), ("zamba2_7b", None), ("qwen2_5_14b", None),
            ("phi3_medium_14b", None), ("chameleon_34b", None),
            ("nemotron_4_340b", None), ("qwen3_moe_235b_a22b", None))
LM_SMALL_STEPS = 8
LM_RTOL, LM_ATOL = 1e-4, 1e-4
LM_BATCH, LM_STEPS, LM_PROFILE_STEPS = 4, 32, 8
LM_PREFILL_BATCH, LM_PREFILL_LEN, LM_PREFILL_TOL = 2, 8, 2e-3
LM_SSM_PREFILL_LEN = 256
# the five archs the card had not run, at full width, after the four
# above: (arch, phase, layers run). The two 14 B models at their published
# depth; the others at the largest depth whose fp32 weights (the port's
# n_params: embedding and head, then per layer) stay at or under ~70 GB of
# the 80, leaving the rest to the KV cache, the logits and the workspace:
# chameleon 4.29 + 23 x 2.77 GB of 48 layers, nemotron 37.75 + 2 x 13.82
# of 96, qwen3_moe 4.98 + 6 x 9.95 of 94
LM_WIDE = (("qwen2_5_14b", "lm_full_qwen2_5", 48),
           ("phi3_medium_14b", "lm_full_phi3", 40),
           ("chameleon_34b", "lm_wide_chameleon", 23),
           ("nemotron_4_340b", "lm_wide_nemotron", 2),
           ("qwen3_moe_235b_a22b", "lm_wide_qwen3_moe", 6))
# training (no hand-written kernel: the reference's train path reaches no
# Pallas kernel). The reduced granite and qwen2_moe (Sinkhorn router) on
# the card against the host: one train step (metrics within
# TRAIN_METRIC_RTOL, each gradient leaf within TRAIN_GRAD_ATOL_SHARE of its
# largest entry), and checkpoint save -> restore -> TRAIN_RESUME_STEPS
# steps against the uninterrupted run (granite bit for bit; the MoE within
# TRAIN_MOE_RESUME_TOL). granite_3_2b at full width through
# launch/train.py's run (TRAIN_FULL_ARGV; remat on, fp32, seed 0): p50
# over the steps after TRAIN_WARMUP, one profiled step, the model-FLOP
# bound. The MoE example's config for TRAIN_MOE_STEPS steps.
TRAIN_SMALL = (("granite_3_2b", None), ("qwen2_moe_a2_7b", "sinkhorn"))
TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ = 4, 32
TRAIN_METRIC_RTOL = 1e-5
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL_SHARE = 1e-4, 1e-4
TRAIN_RESUME_STEPS = 2
TRAIN_MOE_RESUME_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_FULL_ARGV = ("--arch", "granite_3_2b", "--steps", "6",
                   "--global-batch", "8", "--seq-len", "1024",
                   "--log-every", "1", "--seed", "0")
TRAIN_WARMUP = 2
TRAIN_PROFILE_STEP = 5      # the last; traced from the one before it
TRAIN_MOE_ARGV = ("--steps", "100", "--batch", "8", "--seq-len", "256",
                  "--router", "sinkhorn")
TRAIN_CKPT_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_train"
# expert parallelism (no hand-written kernel: the reference's EP path
# reaches no Pallas kernel): qwen2_moe_a2_7b at full width over a
# LM_EP_MESH of positions, every one on the card. LM_STEPS serve steps at
# LM_BATCH with the top-k router and a capacity factor of n_experts /
# top_k (no assignment dropped, globally or per data shard): logits within
# the serve path's LM_EP_TOL of the same model's non-EP logits on the same
# input tokens, one psum per MoE layer a step. The Sinkhorn router (the
# config's) balances per data shard: each layer's data shard i held
# against the non-EP layer on shard i's tokens alone at LM_EP_SHARD_TOL
# (the same products, partial sums added in another order)
LM_EP_MESH = ((2, 4), ("data", "model"))
LM_EP_TOL = 2e-3
LM_EP_SHARD_TOL = 1e-4
# the dry-run: the whole meta sweep (the long_500k cells of the eight
# attention archs skipped, as the reference skips them) into DRYRUN_DIR
# (removed at the end); DRYRUN_CELLS cells walked
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"
DRYRUN_CELLS, DRYRUN_SKIPPED = 64, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one launch of ``fn``: the mean over ``reps``
    launches run back to back. A spin kernel holds the stream while the
    host enqueues them, so the wrapper's host time (tens of us, more than
    a small kernel's run) is hidden from the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def launch_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` single launches, each between its own CUDA
    events with the stream idle: the kernel plus the host time of its
    wrapper until the launch reaches the card (what a caller that syncs
    after each call sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def wall_ms(fn, reps: int = E2E_REPS) -> dict:
    """Host wall time of ``fn`` up to a device sync, over ``reps`` calls:
    median, quartiles and every sample, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "samples": times}


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    tb = n_bytes / PEAK_BYTES_PER_S * 1e3
    tf = n_flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float, name: str) -> tuple[float, float]:
    """Same inf/NaN pattern and finite entries within tolerance."""
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{name}: inf/NaN pattern differs from the "
                             "plain version")
    fin = torch.isfinite(want)
    if not fin.any():
        raise AssertionError(f"{name}: no finite output to compare")
    err = (got[fin] - want[fin]).abs()
    rel = err / want[fin].abs().clamp(min=1e-30)
    bad = err > atol + rtol * want[fin].abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside rtol={rtol} "
            f"atol={atol}; max abs err {float(err.max())}")
    return float(err.max()), float(rel.max())


def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    # fp32 policy: every product of the port is full fp32 (see
    # repro_torch.core.index); TF32 would move bounds and distances
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "torch.backends.cuda.matmul.allow_tf32 must stay False"
    count = torch.cuda.device_count()
    placement = {str(n): [str(d) for d in corpus_mesh(n).devices]
                 for n in SHARD_COUNTS}
    print(f"cuda devices: {count}; shard placement: {placement}",
          flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": count, "shard_placement": placement,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    lib, log = build.build()
    secs = time.perf_counter() - t0
    regs = [ln.split("info    : ")[-1] for ln in log.splitlines()
            if "registers" in ln]
    emit({"phase": "build", "seconds": secs, "library": lib.name,
          "ptxas": regs})


def paper_chunk(v: int, dev, width: int = 48, q: int = 4, seed: int = 0):
    """A query chunk at the main path's widest paper shape: ``q`` queries
    (4, a chunk) of ``width`` support rows drawn from the paper vocabulary,
    some rows masked as the engine pads them."""
    rng = np.random.default_rng(seed)
    sup = np.stack([rng.choice(v, size=width, replace=False)
                    for _ in range(q)])
    # 19-43 live words, in turn
    live = [min((width, 43, 31, 19)[i % 4], width) for i in range(q)]
    mask = np.zeros((q, width), np.float32)
    r = np.ones((q, width), np.float32)
    for i, n in enumerate(live):
        mask[i, :n] = 1.0
        w = rng.random(n).astype(np.float64) + 0.1
        r[i, :n] = (w / w.sum()).astype(np.float32)
    return (torch.as_tensor(sup, dtype=torch.int64, device=dev),
            torch.as_tensor(r, device=dev), torch.as_tensor(mask, device=dev))


def main_path_chunk(corpus, index):
    """The widest query chunk the engine stages for the paper queries: the
    (sup, r, mask) the main path hands K2 and, through the K block, K1."""
    eng = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter)
    qs = list(corpus.queries)
    _, chunks = eng._plan(qs)
    chunk, width = max(chunks, key=lambda c: (c[1], len(c[0])))
    return eng._prep_chunk([qs[qi] for qi in chunk], width)


def hold_min_cdist(name, got, want, a, mask, bsel) -> dict:
    """K2's (and K2s's) output against its plain version: the same +inf
    rows and pattern, and each finite entry within the squared-distance
    tolerance of |a|^2max + |b_v|^2 (``bsel``: the b rows of the output's
    columns). Raises on a miss; returns the largest errors."""
    dead = mask.sum(dim=1) == 0
    if not torch.isinf(got[dead]).all():
        raise AssertionError(f"{name}: all-masked rows must come out +inf")
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{name}: inf/NaN pattern differs from the "
                             "plain version")
    fin = torch.isfinite(want)
    a2max = torch.where(mask > 0, (a * a).sum(-1),
                        torch.zeros_like(mask)).max(dim=1).values
    scale = a2max[:, None] + (bsel * bsel).sum(-1)[None, :]
    err_sq = (got * got - want * want).abs()
    bad = fin & (err_sq > K2_SQ_RTOL * scale)
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside the squared-distance "
            f"tolerance; max |d^2 err| / scale "
            f"{float((err_sq / scale)[fin].max())}")
    err = (got[fin] - want[fin]).abs()
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / want[fin].abs().clamp(
                min=1e-30)).max()),
            "max_sq_err_over_scale": float((err_sq / scale)[fin].max()),
            "sq_rtol": K2_SQ_RTOL, "masked_queries": int(dead.sum())}


def phase_k2(index, sup, mask, label: str) -> dict:
    a = index.vecs[sup]                                  # (Q, B, 300)
    if label == "paper_max":
        mask = mask.clone()
        mask[-1] = 0.0                                   # all-masked row
    b = index.vecs
    got = ops.rwmd_min_cdist(a, mask, b)
    torch.cuda.synchronize()
    want = ref.rwmd_min_cdist_ref(a, mask, b)
    errs = hold_min_cdist("K2", got, want, a, mask, b)
    q, bq, w = a.shape
    v = b.shape[0]
    # the bound counts what this run's data needs: the live support rows
    # of a (masked rows add nothing to the min), all of b, the output
    live_rows = float(mask.sum())
    n_bytes = 4.0 * (live_rows * w + mask.numel() + b.numel() + q * v)
    n_flops = 2.0 * live_rows * w * v + 2.0 * (v + live_rows) * w
    bms, by = bound_ms(n_bytes, n_flops)
    a_live = a[mask > 0].contiguous()                    # (R, w)
    rec = {"phase": "k2", "name": "rwmd_min_cdist", "inputs": label,
           "shape": {"Q": q, "B": bq, "w": w, "V": v,
                     "live_rows": int(live_rows),
                     "masked_queries": errs.pop("masked_queries")},
           **errs,
           "ms": time_ms(lambda: ops.rwmd_min_cdist(a, mask, b)),
           "launch_ms": launch_ms(lambda: ops.rwmd_min_cdist(a, mask, b)),
           "plain_ms": time_ms(lambda: ref.rwmd_min_cdist_ref(a, mask, b),
                               reps=5, warmup=1),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "library": "none: no single PyTorch call computes a masked "
                      "min-over-support cdist (torch.cdist + a masked min "
                      "is two)",
           # a yardstick for the product alone: cuBLAS SGEMM (TF32 off) of
           # the live rows against the vocabulary, no norms, no min
           "sgemm_ms": time_ms(lambda: torch.matmul(a_live, b.T)),
           "sgemm": "torch.matmul (R, w) x (w, V), fp32, TF32 off"}
    emit(rec)
    return rec


def phase_k1(index, sup, r, mask, log_domain: bool, lam: float,
             label: str) -> dict:
    n_iter = CONFIG.n_iter
    grp = index.subset(np.arange(index.n_docs, dtype=np.int32),
                       storage=True)                     # N padded to 8192
    kq = _compute_kq(sup, mask, index.vecs, index.vecs_sq, lam,
                     log_domain=log_domain)
    g = _gather_g(kq, grp.docs.idx)                      # (Q, v_r, N, L)
    val = grp.docs.val
    del kq

    def kernel():
        return ops.sinkhorn_fused_all_batched(g, val, r, lam, n_iter,
                                              log_domain=log_domain)

    def plain():
        return ref.sinkhorn_fused_all_batched_ref(
            g, val, r, lam, n_iter, log_domain=log_domain)[0]

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    abs_err, rel_err = compare(got, want, K1_RTOL, K1_ATOL,
                               f"K1 log_domain={log_domain}")
    q, v_r, n, length = g.shape
    n_live_docs = int((val > 0).any(dim=1).sum())
    # the fixed cost (n_iter = 0, 1) against the cost per iteration (15),
    # and the same call on the live docs alone (the inert docs' share)
    g_live = g[:, :, :n_live_docs].contiguous()
    val_live = val[:n_live_docs].contiguous()
    if not bool((val_live > 0).any(dim=1).all()):
        raise AssertionError("K1: the live docs do not lead the group")

    def run(g=g, val=val, n_iter=n_iter):
        return ops.sinkhorn_fused_all_batched(g, val, r, lam, n_iter,
                                              log_domain=log_domain)
    breakdown = {
        **{f"n_iter_{i}_ms": time_ms(lambda i=i: run(n_iter=i))
           for i in (0, 1)},
        "live_docs_only_ms": time_ms(lambda: run(g=g_live, val=val_live))}
    del g_live
    # bf16 operands and the adaptive exit (fig10's tol and check_every) at
    # this chunk through tile="auto": held against the plain version, and
    # the realized counts equal in every block
    modes = {}
    for mode, opts in (("bf16", dict(gemm="bf16")),
                       ("adaptive", dict(tol=FIG10["tol"],
                                         check_every=FIG10["check_every"]))):
        def run_mode(opts=opts):
            return ops.sinkhorn_fused_all_batched(
                g, val, r, lam, n_iter, log_domain=log_domain,
                with_iters=True, **opts)
        got_m, it_m = run_mode()
        torch.cuda.synchronize()
        held = ref.hold_solve(got_m, it_m, g, val, r, lam, n_iter, K1_RTOL,
                              K1_ATOL, log_domain=log_domain, **opts)
        if held["blocks_count_differs"]:
            raise AssertionError(
                f"K1 {mode} log_domain={log_domain}: "
                f"{held['blocks_count_differs']} block counts differ from "
                "the plain version")
        modes[mode] = {**opts, **held, "ms": time_ms(run_mode)}
        del got_m, it_m
    live_slots = float((val > 0).sum())
    live_rows = float(mask.sum())
    # the bound counts what this run's data needs: G at live (query row,
    # doc slot) pairs (pad rows, pad slots and pad docs add exact zeros),
    # val at live slots, r, and the outputs
    n_bytes = 4.0 * (live_rows * live_slots + live_slots + r.numel()
                     + q * n + q * -(-n // 128))
    # per live (query row, doc slot): 4 flops per iteration (SDDMM +
    # SpMM multiply-adds), the last SDDMM and the distance line
    n_flops = live_rows * live_slots * (4.0 * n_iter + 4.0)
    bms, by = bound_ms(n_bytes, n_flops)
    rec = {"phase": "k1", "name": "sinkhorn_fused_all_batched",
           "inputs": label, "log_domain": log_domain, "lam": lam,
           "n_iter": n_iter,
           "shape": {"Q": q, "v_r": v_r, "N": n, "L": length,
                     "live_docs": n_live_docs, "live_slots": int(live_slots),
                     "live_rows": int(live_rows)},
           "max_abs_err": abs_err, "max_rel_err": rel_err,
           "rtol": K1_RTOL, "atol": K1_ATOL,
           "ms": time_ms(kernel), "launch_ms": launch_ms(kernel),
           "plain_ms": time_ms(plain, reps=5, warmup=1),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "library": "none: no single PyTorch call computes a Sinkhorn "
                      "solve", "breakdown": breakdown, "modes": modes}
    emit(rec)
    del g
    return rec


def phase_k1_tiles(index, sup, r, mask) -> dict:
    """K1's variants on the main path's widest chunk: the warp per tile
    (what ``tile="auto"`` picks there) against the tile in shared memory,
    each held against the plain version and timed; then the warp per tile
    in every tile class up to 64 x 64."""
    grp = index.subset(np.arange(index.n_docs, dtype=np.int32),
                       storage=True)
    rec = {"phase": "k1_tiles"}
    for log_domain, lam in ((True, CONFIG.lam), (False, 1.0)):
        g = _gather_g(_compute_kq(sup, mask, index.vecs, index.vecs_sq, lam,
                                  log_domain=log_domain), grp.docs.idx)
        want = ref.sinkhorn_fused_all_batched_ref(
            g, grp.docs.val, r, lam, CONFIG.n_iter, log_domain=log_domain)[0]
        key = "log" if log_domain else "fp32"
        rec[key] = {"shape": list(g.shape)}
        for tile in ("shared", "warp"):
            def run(tile=tile):
                return ops.sinkhorn_fused_all_batched(
                    g, grp.docs.val, r, lam, CONFIG.n_iter,
                    log_domain=log_domain, tile=tile)
            abs_err, _ = compare(run(), want, K1_RTOL, K1_ATOL,
                                 f"K1 tile={tile} log_domain={log_domain}")
            rec[key][tile] = {"ms": time_ms(run), "max_abs_err": abs_err}
        del g
    # the other tile classes (no paper chunk has them): Q=4, N=2048
    # synthetic docs, fp32 at lam=1 and log at lam=10
    rec["classes"] = []
    for v_r, length in K1_CLASSES:
        sup_c, r_c, mask_c = paper_chunk(index.vocab_size, mask.device,
                                         width=v_r, seed=10)
        idx, val = wide_docs(index, mask.device, 2048, length, seed=11)
        row = {"v_r": v_r, "L": length}
        for log_domain, lam in ((False, 1.0), (True, CONFIG.lam)):
            g = _gather_g(_compute_kq(sup_c, mask_c, index.vecs,
                                      index.vecs_sq, lam,
                                      log_domain=log_domain), idx)
            want = ref.sinkhorn_fused_all_batched_ref(
                g, val, r_c, lam, CONFIG.n_iter, log_domain=log_domain)[0]
            def run(g=g, lam=lam, log_domain=log_domain):
                return ops.sinkhorn_fused_all_batched(
                    g, val, r_c, lam, CONFIG.n_iter, log_domain=log_domain,
                    tile="warp")
            compare(run(), want, K1_RTOL, K1_ATOL,
                    f"K1 {v_r}x{length} tile=warp log={log_domain}")
            row["log" if log_domain else "fp32"] = {"warp": time_ms(run)}
            del g, want
        rec["classes"].append(row)
    emit(rec)
    return rec


def phase_k1_wide(index, dev, crossover) -> dict:
    """K1's variants for tiles wider than 64 query rows or doc slots (no
    paper shape is): the shared-memory one on 96-row queries, held against
    the plain version and timed beside the device-memory one at that
    shape; the two variants on the ``crossover`` tiles
    (:func:`phase_k1_crossover`); then the tile over the shared-memory
    limit (:func:`phase_k1_over_limit`)."""
    sup, r, mask = paper_chunk(index.vocab_size, dev, width=96, q=2, seed=1)
    grp = index.subset(np.arange(1024, dtype=np.int32), storage=True)
    for log_domain, lam in ((False, 1.0), (True, CONFIG.lam)):
        g = _gather_g(_compute_kq(sup, mask, index.vecs, index.vecs_sq, lam,
                                  log_domain=log_domain), grp.docs.idx)
        got = ops.sinkhorn_fused_all_batched(g, grp.docs.val, r, lam,
                                             CONFIG.n_iter,
                                             log_domain=log_domain)
        torch.cuda.synchronize()
        want = ref.sinkhorn_fused_all_batched_ref(
            g, grp.docs.val, r, lam, CONFIG.n_iter, log_domain=log_domain)[0]
        abs_err, _ = compare(got, want, K1_RTOL, K1_ATOL,
                             f"K1 wide log_domain={log_domain}")
        rec = {"phase": "k1_wide", "log_domain": log_domain,
               "shape": list(g.shape), "max_abs_err": abs_err}
        for tile in ("shared", "global"):
            def run(tile=tile, g=g, lam=lam, log_domain=log_domain):
                return ops.sinkhorn_fused_all_batched(
                    g, grp.docs.val, r, lam, CONFIG.n_iter,
                    log_domain=log_domain, tile=tile)
            rec[tile] = {"max_abs_err": compare(
                run(), want, K1_RTOL, K1_ATOL,
                f"K1 wide tile={tile} log_domain={log_domain}")[0],
                "ms": time_ms(run)}
        emit(rec)
        del g
    phase_k1_crossover(index, dev, crossover)
    return phase_k1_over_limit(index, dev)


# (v_r, L) tiles on each side of where K1's "auto" switches from the
# shared-memory to the device-memory variant (kTwoBlockSmem in
# sinkhorn_fused.cu), and the sweep that placed the switch, between the
# two measured ends of the crossover (96 x 28, 192 x 192), which
# ``--k1-crossover-sweep`` runs instead
K1_CROSSOVER = ((160, 160), (176, 176))
K1_CROSSOVER_SWEEP = ((96, 28), (96, 64), (128, 64), (128, 128), (160, 128),
                      (160, 160), (176, 176), (192, 192))


def phase_k1_crossover(index, dev, shapes) -> dict:
    """Where ``tile="auto"`` switches from the shared-memory variant to the
    device-memory one: both held against the plain version and timed on
    the (v_r, L) ``shapes`` (Q=2, N=512 synthetic docs of the paper
    vocabulary, fp32 at lam=1 and log at lam=10), beside what ``auto``
    takes there."""
    n_docs = 512
    rec = {"phase": "k1_crossover", "Q": 2, "N": n_docs,
           "n_iter": CONFIG.n_iter, "shapes": []}
    for v_r, length in shapes:
        sup, r, mask = paper_chunk(index.vocab_size, dev, width=v_r, q=2,
                                   seed=8)
        idx, val = wide_docs(index, dev, n_docs, length, seed=9)
        row = {"v_r": v_r, "L": length}
        for log_domain, lam in ((False, 1.0), (True, CONFIG.lam)):
            g = _gather_g(_compute_kq(sup, mask, index.vecs, index.vecs_sq,
                                      lam, log_domain=log_domain), idx)
            want = ref.sinkhorn_fused_all_batched_ref(
                g, val, r, lam, CONFIG.n_iter, log_domain=log_domain)[0]
            times = {}
            for tile in ("shared", "global", "auto"):
                def run(tile=tile, g=g, lam=lam, log_domain=log_domain):
                    return ops.sinkhorn_fused_all_batched(
                        g, val, r, lam, CONFIG.n_iter,
                        log_domain=log_domain, tile=tile)
                compare(run(), want, K1_RTOL, K1_ATOL,
                        f"K1 {v_r}x{length} tile={tile} log={log_domain}")
                times[tile] = time_ms(run)
            times["faster"] = min(("shared", "global"), key=times.get)
            row["log" if log_domain else "fp32"] = times
            del g, want
        rec["shapes"].append(row)
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def phase_small_parity(dev) -> None:
    """The engine on the card against the same engine on the host (the
    kernels' plain versions) on a small corpus."""
    c = make_corpus(vocab_size=2048, embed_dim=64, n_docs=256, n_queries=6,
                    seed=3)
    qs = list(c.queries)
    out = {}
    for d in (dev, torch.device("cpu")):
        eng = WmdEngine(build_index(c.docs, c.vecs, device=d), lam=1.0,
                        n_iter=15)
        out[d.type] = (eng.search(qs, 5), eng.query_batch(qs).numpy())
    (sg, dg), (sc, dc) = out["cuda"], out["cpu"]
    if not np.array_equal(sg.indices, sc.indices):
        raise AssertionError("small corpus: card and host top-5 differ")
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sg.distances, sc.distances, rtol=1e-4,
                               atol=1e-5)
    emit({"phase": "small_parity", "n_docs": 256, "queries": len(qs),
          "max_abs_diff": float(np.abs(dg - dc).max()), "ok": True})


def phase_end_to_end(corpus, index, precision: str, lam: float,
                     k: int = 10) -> dict:
    qs = list(corpus.queries)
    eng = WmdEngine(index, lam=lam, n_iter=CONFIG.n_iter,
                    precision=precision)
    eng.search(qs, k, prune="rwmd")                       # warm-up run
    torch.cuda.synchronize()
    ops.reset_launches()
    res = eng.search(qs, k, prune="rwmd")                 # the counted run
    torch.cuda.synchronize()
    launches = ops.launches()
    search = wall_ms(lambda: eng.search(qs, k, prune="rwmd"))
    eng.query_batch(qs)                                   # warm-up run
    full = eng.query_batch(qs).numpy()
    batch = wall_ms(lambda: eng.query_batch(qs))
    if np.isnan(full).any() or np.isnan(res.distances).any():
        raise AssertionError(f"{precision}: NaN in the distances")
    ex_i = np.argsort(full, axis=1, kind="stable")[:, :k]
    ex_d = np.take_along_axis(full, ex_i, axis=1)
    if not np.array_equal(res.indices, ex_i):
        raise AssertionError(f"{precision}: staged top-{k} ids differ from "
                             f"the exhaustive top-{k}")
    np.testing.assert_allclose(res.distances, ex_d, rtol=E2E_RTOL, atol=0)
    for name in ("rwmd_min_cdist", "sinkhorn_fused_all_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by search")
    rec = {"phase": "end_to_end", "precision": precision, "lam": lam,
           "n_iter": CONFIG.n_iter, "k": k, "queries": len(qs),
           "n_docs": index.n_docs, "vocab": index.vocab_size,
           "embed_dim": index.embed_dim,
           "search_ms_per_batch": search,
           "query_batch_ms": batch,
           "queries_per_s": len(qs) / (search["median"] / 1e3),
           "solved_per_query": res.solved.tolist(),
           "launches": launches,
           "max_dist_rel_diff": float(np.max(np.abs(res.distances - ex_d)
                                             / np.abs(ex_d))),
           "top_k_equal": True}
    emit(rec)
    return rec


def phase_profile(corpus, index, k: int = 10, reps: int = 5,
                  impl: str = "kernel") -> None:
    """Where the time of a search goes: torch.profiler over ``reps`` warm
    ``search`` calls (log, lam=10) of the ``impl`` engine; device busy
    share = the kernels' summed device time over the wall time (one
    stream, so no overlap). Times are per search."""
    qs = list(corpus.queries)
    eng = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                    precision="log", impl=impl)
    out = profile_window(lambda: eng.search(qs, k, prune="rwmd"), reps)
    emit(profile_record("profile", *out, reps, precision="log",
                        lam=CONFIG.lam, impl=impl))


def phase_underflow(corpus, index) -> None:
    """fp32 at the config's own lam=10 underflows K on this corpus
    (lam*dist ~ 200 > 87): the engine must raise, not return NaN."""
    eng = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter)
    try:
        eng.query_batch(list(corpus.queries[:2]))
    except LamUnderflowError:
        emit({"phase": "underflow_guard", "lam": CONFIG.lam,
              "precision": "fp32", "raised": "LamUnderflowError"})
        return
    raise AssertionError("fp32 at lam=10 returned without raising "
                         "LamUnderflowError")


def widest_query(corpus) -> np.ndarray:
    """The paper query with the most unique words (23 at seed 0): the
    one-query phases' input."""
    return max(corpus.queries, key=lambda q: int((q > 0).sum()))


def device_docs(docs, dev) -> PaddedDocs:
    return PaddedDocs(idx=torch.as_tensor(docs.idx, dtype=torch.int64,
                                          device=dev),
                      val=torch.as_tensor(docs.val, device=dev))


def k3_bound(v_r: int, w: int, v: int, n_out: int) -> tuple[float, str]:
    """a, b and r read once, ``n_out`` (v_r, V) outputs written once; the
    product and the norms."""
    n_bytes = 4.0 * (v_r * w + v * w + v_r + n_out * v_r * v)
    n_flops = 2.0 * v_r * w * v + 2.0 * (v_r + v) * w
    return bound_ms(n_bytes, n_flops)


def phase_k3(vecs, a, r, label: str) -> list[dict]:
    """K3 in its three modes on one query's support rows ``a``."""
    recs = []
    v_r, w = a.shape
    v = vecs.shape[0]
    for mode, lam, k_only, log_k in (("full", 1.0, False, False),
                                     ("k_only", 1.0, True, False),
                                     ("log_k", CONFIG.lam, True, True)):
        def kernel():
            return ops.cdist_exp(a, vecs, r, lam, k_only=k_only, log_k=log_k)

        def plain():
            return ref.cdist_exp_ref(a, vecs, r, lam, k_only=k_only,
                                     log_k=log_k)

        got = kernel()
        torch.cuda.synchronize()
        errs = ref.hold_cdist_exp(got, a, vecs, r, lam, k_only, log_k)
        del got
        bms, by = k3_bound(v_r, w, v, 1 if k_only else 3)
        rec = {"phase": "k3", "name": "cdist_exp", "inputs": label,
               "mode": mode, "lam": lam,
               "shape": {"v_r": v_r, "w": w, "V": v}, **errs,
               "sq_rtol": ref.K3_SQ_RTOL, "ms": time_ms(kernel),
               "launch_ms": launch_ms(kernel),
               "plain_ms": time_ms(plain, reps=5, warmup=1),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "library": "none: no single PyTorch call computes "
                          "exp(-lam*cdist); torch.cdist gives M alone"}
        emit(rec)
        recs.append(rec)
    return recs


def solver_bound(v_r: int, val, n_iter: int) -> tuple[float, str]:
    """K4's bound for one query of ``v_r`` live rows, as K1's: G and val
    at live doc slots (pad slots and docs add exact zeros), r, the
    outputs; 4 flops per live (row, slot) pair and iteration, plus the
    last SDDMM and the distance line."""
    live_slots = float((val > 0).sum())
    n = val.shape[0]
    n_bytes = 4.0 * (v_r * live_slots + live_slots + v_r + n + -(-n // 128))
    return bound_ms(n_bytes, v_r * live_slots * (4.0 * n_iter + 4.0))


def gathered(vecs, docs, r, vecs_sel, lam: float, log_k: bool):
    """The one-query G: the plain K (or log K) gathered at the doc words."""
    return gather_columns(ref.cdist_exp_ref(vecs_sel, vecs, r, lam,
                                            k_only=True, log_k=log_k),
                          docs.idx)


def phase_k4(vecs, docs, r, vecs_sel) -> list[dict]:
    """K4 on the gathered G of one paper query against every document."""
    recs = []
    n_iter = CONFIG.n_iter
    for log_domain, lam in ((False, 1.0), (True, CONFIG.lam)):
        g = gathered(vecs, docs, r, vecs_sel, lam, log_domain)

        def kernel():
            return ops.sinkhorn_fused_all(g, docs.val, r, lam, n_iter,
                                          log_domain=log_domain)

        def plain():
            return ref.sinkhorn_fused_all_ref(g, docs.val, r, lam, n_iter,
                                              log_domain=log_domain)[0]

        got = kernel()
        torch.cuda.synchronize()
        abs_err, rel_err = compare(got, plain(), K4_RTOL, K4_ATOL,
                                   f"K4 log_domain={log_domain}")
        bms, by = solver_bound(g.shape[0], docs.val, n_iter)
        v_r, n, length = g.shape
        rec = {"phase": "k4", "name": "sinkhorn_fused_all",
               "log_domain": log_domain, "lam": lam, "n_iter": n_iter,
               "shape": {"v_r": v_r, "N": n, "L": length,
                         "live_slots": int((docs.val > 0).sum())},
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "rtol": K4_RTOL, "atol": K4_ATOL, "ms": time_ms(kernel),
               "launch_ms": launch_ms(kernel),
               "plain_ms": time_ms(plain, reps=5, warmup=1),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "library": "none: no single PyTorch call computes a "
                          "Sinkhorn solve"}
        emit(rec)
        recs.append(rec)
    return recs


def k5_check(pre, x0, label: str) -> dict:
    """K5 once on ``pre``'s G and G/r from ``x0`` against its plain
    version; its time, and its two bounds: the bytes its data needs (G and
    G/r at live slots, where w can be nonzero) and the bytes as laid out
    (G and G/r at every slot, what the kernel reads), with the rate it
    reads those at. The bound of the kernels line is the first."""
    v_r, n, length = pre.G.shape

    def kernel():
        return ops.sddmm_spmm_step(pre.G, pre.G_over_r, pre.val, x0)

    def plain():
        return ref.sddmm_spmm_step_ref(pre.G, pre.G_over_r, pre.val, x0)

    got = kernel()
    torch.cuda.synchronize()
    abs_err, rel_err = compare(got, plain(), K5_RTOL, K5_ATOL,
                               f"K5 {label}")
    live_slots = float((pre.val > 0).sum())
    # G and G/r at live slots (w is 0 on pad slots, so neither is needed
    # there), val at live slots, x in, x' out
    n_bytes = 4.0 * (2 * v_r * live_slots + live_slots + 2 * v_r * n)
    bms, by = bound_ms(n_bytes, 4.0 * v_r * live_slots)
    laid_out = 4.0 * (2 * v_r * n * length + n * length + 2 * v_r * n)
    ms = time_ms(kernel)
    return {"label": label, "shape": {"v_r": v_r, "N": n, "L": length,
                                      "live_slots": int(live_slots)},
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "rtol": K5_RTOL, "atol": K5_ATOL, "ms": ms,
            "launch_ms": launch_ms(kernel),
            "plain_ms": time_ms(plain, reps=5, warmup=1),
            "bound_ms": bms, "bound_by": by,
            "bound_laid_out_ms": bound_ms(laid_out,
                                          4.0 * v_r * n * length)[0],
            "laid_out_tb_per_s": laid_out / (ms * 1e-3) / 1e12}


def k5_subnormal_inputs(edge: str):
    """tests/test_torch_kernels.py's ``_k5_inputs`` at K5_SUBNORMAL_SHAPE
    for ``edge`` "subnormal" or "subnormal_live", drawn from that test
    case's own seed (conftest's: adler32 of its node id): (g, G/r, val, x)
    in numpy fp32. Each doc's live slots end at a drawn slot (with dead
    slots inside); then the subnormal G column at K5_SUBNORMAL_DOC's
    K5_SUBNORMAL_SLOT, dead past the doc's last live slot, or live."""
    import zlib
    v_r, n, length = K5_SUBNORMAL_SHAPE
    rng = np.random.default_rng(zlib.adler32(
        "tests/test_torch_kernels.py::test_sddmm_spmm_step_plain_matches_"
        f"pallas[{edge}]".encode()))
    g = np.abs(rng.standard_normal((v_r, n, length))).astype(np.float32)
    g += 0.1
    gor = g * 1.7
    val = np.abs(rng.standard_normal((n, length))).astype(np.float32)
    val = np.where(val > 0.8, val, 0.0).astype(np.float32)
    x = (np.abs(rng.standard_normal((v_r, n))) + 0.5).astype(np.float32)
    x[0, :4] = 0.0
    ends = rng.integers(0, length + 1, n)
    ends[:3] = (0, length, 1)
    for d, e in enumerate(ends):
        val[d, e:] = 0.0
        if e:
            val[d, e - 1] = 1.0 + rng.random()
    if edge == "subnormal":
        val[K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT - 4:] = 0.0
    else:
        val[K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 1.5
    g[:, K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 1e-42
    return g, gor, val, x


def k5_subnormal(dev) -> dict:
    """K5 against its plain version at the subnormal inputs: no NaN, and
    within K5's tolerance everywhere."""
    out = {}
    for edge in ("subnormal", "subnormal_live"):
        g, gor, val, x = (torch.as_tensor(a, device=dev)
                          for a in k5_subnormal_inputs(edge))
        got = ops.sddmm_spmm_step(g, gor, val, x)
        want = ref.sddmm_spmm_step_ref(g, gor, val, x)
        if torch.isnan(got).any() or torch.isnan(want).any():
            raise AssertionError(f"K5 {edge}: NaN at a subnormal t")
        err = compare(got, want, K5_RTOL, K5_ATOL, f"K5 {edge}")
        out[edge] = {"shape": list(K5_SUBNORMAL_SHAPE),
                     "max_abs_err": err[0]}
    return out


def phase_k5(vecs, docs, r, vecs_sel) -> dict:
    """K5 on one paper query's G and G/r from the uniform start, and on a
    200-word query's; then its path: ``CONFIG.n_iter`` steps through
    ``ops.sddmm_spmm_step`` against the sparse solver's fused loop, with
    the path's device time."""
    pre = precompute_sparse(r, vecs_sel, vecs, docs, 1.0)
    v_r, n, length = pre.G.shape
    x0 = torch.full((v_r, n), 1.0 / v_r, device=vecs.device)
    paper = k5_check(pre, x0, "widest_paper_query")

    def path():
        x = x0
        for _ in range(CONFIG.n_iter):
            x = ops.sddmm_spmm_step(pre.G, pre.G_over_r, pre.val, x)
        return x

    ops.reset_launches()                  # the path: a solve of K5 steps
    x = path()
    torch.cuda.synchronize()
    launches = ops.launches()
    path_err = compare(x, _iterate(pre, CONFIG.n_iter), 1e-4, 0.0,
                       "K5 path against the sparse solver's loop")
    if launches["sddmm_spmm_step"] != CONFIG.n_iter:
        raise AssertionError(f"K5 path launched {launches}")
    path_ms = time_ms(path, reps=10)

    rng = np.random.default_rng(4)
    wide = torch.as_tensor(rng.choice(vecs.shape[0], 200, replace=False),
                           device=vecs.device)
    rw = rng.uniform(0.1, 1.0, 200)
    pre200 = precompute_sparse(
        torch.as_tensor(rw / rw.sum(), dtype=torch.float32,
                        device=vecs.device),
        vecs[wide].contiguous(), vecs, docs, 1.0)
    del pre
    wide_rec = k5_check(pre200, torch.full((200, n), 1.0 / 200,
                                           device=vecs.device), "query_200")
    del pre200
    subnormal = k5_subnormal(vecs.device)
    rec = {"phase": "k5", "name": "sddmm_spmm_step", "lam": 1.0,
           **{k: v for k, v in paper.items() if k != "label"},
           "library_ms": None,
           "library": "none: no single PyTorch call computes an SDDMM "
                      "fused with an SpMM",
           "query_200": wide_rec, "subnormal": subnormal,
           "path": {"steps": CONFIG.n_iter, "launches": launches,
                    "ms": path_ms,
                    "x_max_abs_and_rel_err_vs_sparse_loop": path_err}}
    emit(rec)
    return rec


def phase_one_to_many(corpus, dev) -> dict:
    """The paper's one-query workload at its widths, every impl, all 10
    queries: agreement with dense, the log domain, the underflow guard,
    timings with inputs on the card and from numpy, and the launches of
    one ``impl="kernel"`` call."""
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    docs = device_docs(corpus.docs, dev)
    lam, n_iter = 1.0, CONFIG.n_iter
    rec = {"phase": "one_to_many", "lam": lam, "n_iter": n_iter,
           "queries": len(corpus.queries), "n_docs": corpus.docs.idx.shape[0],
           "vocab": vecs.shape[0], "embed_dim": vecs.shape[1]}
    held = {"sparse": OTM_RTOL, "sparse_unfused": OTM_RTOL,
            "kernel": P1_RTOL, "kernel_plain_k": OTM_RTOL,
            "kernel_log_vs_sparse_log": P1_RTOL,
            "dense_stabilized_converged": OTM_RTOL}
    gap = dict.fromkeys(held, 0.0)
    missed = []

    def hold(key, got, want):
        gap[key] = max(gap[key], float(((got - want).abs()
                                        / want.abs()).max()))
        try:
            compare(got, want, held[key], OTM_ATOL, key)
        except AssertionError as e:
            missed.append(str(e))

    for q in corpus.queries:
        want = one_to_many(q, docs, vecs, lam, n_iter, "dense", device=dev)
        for impl in ("sparse", "sparse_unfused", "kernel"):
            hold(impl, one_to_many(q, docs, vecs, lam, n_iter, impl,
                                   device=dev), want)
        # P1's share: the kernel path with K3's output replaced by its
        # plain version (the dense impl's GEMM)
        r, vecs_sel, _ = select_support(q, vecs)
        hold("kernel_plain_k", ops.sinkhorn_fused_all(
            gathered(vecs, docs, r, vecs_sel, lam, False), docs.val, r, lam,
            n_iter), want)
        hold("kernel_log_vs_sparse_log",
             ops.sinkhorn_wmd_kernel(r, vecs_sel, vecs, docs, CONFIG.lam,
                                     n_iter, precision="log"),
             sinkhorn_wmd_sparse(r, vecs_sel, vecs, docs, CONFIG.lam, n_iter,
                                 precision="log"))
    # the log-domain dense iteration reaches the scaling iteration's fixed
    # point from another start, so the two agree once converged
    q = widest_query(corpus)
    stab_docs = PaddedDocs(idx=docs.idx[:STAB_DOCS], val=docs.val[:STAB_DOCS])
    hold("dense_stabilized_converged",
         one_to_many(q, stab_docs, vecs, lam, STAB_ITERS, "dense_stabilized",
                     device=dev),
         one_to_many(q, stab_docs, vecs, lam, STAB_ITERS, "dense",
                     device=dev))
    rec["dense_stabilized"] = {"docs": STAB_DOCS, "n_iter": STAB_ITERS}
    try:
        one_to_many(q, docs, vecs, CONFIG.lam, n_iter, "kernel", device=dev)
    except LamUnderflowError:
        rec["lam10_linear_kernel"] = "LamUnderflowError"
    else:
        raise AssertionError("linear one_to_many(impl='kernel') at lam=10 "
                             "returned without raising LamUnderflowError")

    ops.reset_launches()                  # the path: one kernel-impl call
    one_to_many(q, docs, vecs, lam, n_iter, "kernel", device=dev)
    torch.cuda.synchronize()
    rec["launches_per_kernel_call"] = ops.launches()
    for name in ("cdist_exp", "sinkhorn_fused_all"):
        if rec["launches_per_kernel_call"][name] <= 0:
            raise AssertionError(f"{name} was not launched by one_to_many")

    timings = {}
    for where, (d_in, v_in) in (("on_card", (docs, vecs)),
                                ("numpy", (corpus.docs, corpus.vecs))):
        timings[where] = {}
        for impl in ("dense", "dense_stabilized", "sparse",
                     "sparse_unfused", "kernel"):
            dd = d_in
            if impl == "dense_stabilized":
                dd = PaddedDocs(idx=d_in.idx[:STAB_DOCS],
                                val=d_in.val[:STAB_DOCS])
            reps = DENSE_REPS if impl == "dense" else OTM_REPS

            def call(impl=impl, dd=dd):
                return one_to_many(q, dd, v_in, lam, n_iter, impl, device=dev)

            call()                                        # warm-up
            timings[where][impl] = wall_ms(call, reps=reps)
    rec["max_rel_gap"] = gap
    rec["rtol"], rec["atol"] = held, OTM_ATOL
    rec["wall_ms"] = timings
    med = {k: v["median"] for k, v in timings["on_card"].items()}
    rec["dense_over_sparse"] = med["dense"] / med["sparse"]
    rec["dense_over_kernel"] = med["dense"] / med["kernel"]
    rec["sparse_over_kernel"] = med["sparse"] / med["kernel"]
    emit(rec)
    if missed:
        raise AssertionError("one_to_many: " + "; ".join(missed))
    return rec


def phase_many_to_many(corpus, dev) -> None:
    """``many_to_many(batched=True, impl="kernel")`` (the K1 engine)
    against the per-query loop of ``one_to_many(impl="kernel")``."""
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    docs = device_docs(corpus.docs, dev)
    qs = list(corpus.queries)
    batched = many_to_many(qs, docs, vecs, 1.0, CONFIG.n_iter, "kernel",
                           device=dev)
    looped = many_to_many(qs, docs, vecs, 1.0, CONFIG.n_iter, "kernel",
                          batched=False, device=dev)
    gap = 0.0
    for b, lo in zip(batched, looped):
        lo = lo.cpu()
        gap = max(gap, compare(b, lo, M2M_RTOL, 0.0,
                               "many_to_many batched vs looped")[1])
    emit({"phase": "many_to_many", "impl": "kernel", "lam": 1.0,
          "queries": len(qs), "max_rel_gap_batched_vs_looped": gap,
          "rtol": M2M_RTOL})


def profile_window(fn, reps: int) -> tuple[float, list, list, float]:
    """torch.profiler over ``reps`` warm calls of ``fn``: (wall us per
    call, device events, host events, device busy us per call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    dev_ev, host, busy = split_events(prof.key_averages())
    return wall_us, dev_ev, host, busy / reps


def split_events(ev) -> tuple[list, list, float]:
    """(device events, host events, device busy us) of ``key_averages``;
    a scheduled profiler's ``ProfilerStep*`` range is neither."""
    ev = [e for e in ev if not e.key.startswith("ProfilerStep")]
    dev_ev = [e for e in ev
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    host = [e for e in ev
            if not str(getattr(e, "device_type", "")).endswith("CUDA")]
    return dev_ev, host, sum(e.self_device_time_total for e in dev_ev)


def profile_record(phase: str, wall_us, dev_ev, host, busy_us, reps,
                   **extra) -> dict:
    if not dev_ev:
        return {"phase": phase, "wall_ms": wall_us / 1e3,
                "device_time": "not measured (no device events traced)"}
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:12]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]
    api = {e.key: e.count / reps for e in host
           if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync",
                        "cudaLaunchKernel", "cudaLaunchKernelExC")}
    return {"phase": phase, **extra, "calls": reps,
            "runtime_calls_per_call": api,
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernels": [{"name": e.key[:80], "count": e.count / reps,
                         "device_ms": e.self_device_time_total / 1e3 / reps}
                        for e in top],
            "host_ops": [{"name": e.key[:60], "count": e.count / reps,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3 / reps}
                         for e in top_host]}


def phase_profile_one_to_many(corpus, dev, reps: int = 5) -> None:
    """Where the time of one ``one_to_many(impl="kernel")`` call goes
    (fp32, lam=1, inputs on the card), averaged over ``reps`` calls."""
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    docs = device_docs(corpus.docs, dev)
    q = widest_query(corpus)
    out = profile_window(
        lambda: one_to_many(q, docs, vecs, 1.0, CONFIG.n_iter, "kernel",
                            device=dev),
        reps)
    emit(profile_record("profile_one_to_many", *out, reps, impl="kernel",
                        lam=1.0))


class CapturingCascade(CascadePruner):
    """The cascade as a user would pass it to ``search``, recording the
    inputs of each of its K2s calls: the (sup, mask) of the staging and
    the candidate vocabulary of the RWMD stage."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []

    def _rwmd_prep(self, index, sup, mask, ids_pad, n_real):
        staged = self._rwmd_vocab(index, ids_pad, n_real)
        if staged is not None:
            self.calls.append((sup, mask, torch.as_tensor(
                staged[0], device=index.device)))
        return super()._rwmd_prep(index, sup, mask, ids_pad, n_real)


def phase_k2s(index, sup, mask, vids, label: str) -> dict:
    """K2s against its plain version on one (sup, mask, vocab_ids), with
    the route its launcher takes there."""
    a = index.vecs[sup]
    b = index.vecs

    def kernel():
        return ops.rwmd_min_cdist(a, mask, b, vocab_ids=vids)

    def plain():
        return ref.rwmd_min_cdist_subset_ref(a, mask, b, vids)

    before = ops.rwmd_min_cdist_subset.launches
    got = kernel()
    torch.cuda.synchronize()
    if ops.rwmd_min_cdist_subset.launches != before + 1:
        raise AssertionError("K2s: a call must be one launch")
    errs = hold_min_cdist("K2s", got, plain(), a, mask, b[vids])
    q, bq, w = a.shape
    vc = vids.numel()
    n_rows = int(torch.unique(vids).numel())
    live_rows = float(mask.sum())
    # what this run's data needs: the live support rows of a, each distinct
    # vocabulary row once, the ids, and the (Q, Vc) output; the product
    # over the distinct rows
    n_bytes = (4.0 * (live_rows * w + mask.numel() + n_rows * w + q * vc)
               + 8.0 * vc)
    n_flops = 2.0 * live_rows * w * n_rows + 2.0 * (n_rows + live_rows) * w
    bms, by = bound_ms(n_bytes, n_flops)
    rec = {"phase": "k2s", "name": "rwmd_min_cdist_subset", "inputs": label,
           "shape": {"Q": q, "B": bq, "w": w, "V": b.shape[0], "Vc": vc,
                     "distinct_rows": n_rows, "live_rows": int(live_rows),
                     "live_per_query": [int(x) for x in mask.sum(dim=1)],
                     "masked_queries": errs.pop("masked_queries")},
           "subset_route": ops.rwmd_subset_route(q, bq, vc),
           **errs, "ms": time_ms(kernel), "launch_ms": launch_ms(kernel),
           "plain_ms": time_ms(plain, reps=5, warmup=1),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "library": "none: no single PyTorch call computes it "
                      "(index_select of the rows, torch.cdist and a masked "
                      "min are three)"}
    emit(rec)
    return rec


def build_dedup(dev):
    """The dedup corpus and its index with n_clusters="auto": (corpus,
    index, build seconds)."""
    corpus = dedup_corpus(DEDUP_DOCS, vocab=CONFIG.vocab_size,
                          embed_dim=CONFIG.embed_dim, seed=0)
    t0 = time.perf_counter()
    index = build_index(corpus.docs, corpus.vecs, device=dev,
                        n_clusters="auto")
    torch.cuda.synchronize()
    return corpus, index, time.perf_counter() - t0


def recall(res, ex) -> float:
    return float(np.mean([len(set(res.indices[qi]) & set(ex.indices[qi]))
                          / ex.indices.shape[1]
                          for qi in range(ex.indices.shape[0])]))


def hold_topk(res, want, name: str) -> None:
    """The same top-k ids, and distances at E2E_RTOL."""
    if not np.array_equal(res.indices, want.indices):
        raise AssertionError(f"{name}: top-{TOP_K} ids differ")
    np.testing.assert_allclose(res.distances, want.distances, rtol=E2E_RTOL,
                               atol=0, err_msg=name)


def monotone(values: list, name: str) -> None:
    if any(b < a - 1e-12 for a, b in zip(values, values[1:])):
        raise AssertionError(f"{name}: recall not monotone: {values}")


def phase_cascade(corpus, index, build_s: float) -> dict:
    """The IVF cascade and refine search on the dedup corpus: exactness
    gates at precision="log" (lam=10) and fp32 (lam=1), solved counts,
    recall over nprobe and refine_factor, the launches of one
    "ivf+wcd+rwmd" search, and the wall times of the log searches."""
    t0 = time.perf_counter()
    qs = list(corpus.queries)
    n = index.n_docs
    rec = {"phase": "cascade", "n_docs": n, "vocab": index.vocab_size,
           "embed_dim": index.embed_dim, "queries": len(qs), "k": TOP_K,
           "n_iter": CONFIG.n_iter, "n_clusters_auto":
               index.clusters.n_clusters,
           "default_n_clusters": default_n_clusters(n),
           "build_seconds": build_s}
    cover = -(-n // TOP_K)
    for precision, lam in (("log", CONFIG.lam), ("fp32", 1.0)):
        eng = WmdEngine(index, lam=lam, n_iter=CONFIG.n_iter,
                        precision=precision)
        ex = eng.search(qs, TOP_K, prune=None)
        if not np.isfinite(ex.distances).all():
            raise AssertionError(f"{precision}: non-finite distances")
        out = {"lam": lam, "solved": {}}
        for spec in CASCADE_SPECS + ("rwmd",):
            res = eng.search(qs, TOP_K, prune=spec)
            hold_topk(res, ex, f"{precision} {spec} nprobe=None")
            out["solved"][spec] = res.solved.tolist()
        exact = eng.search(qs, TOP_K, prune=REFINE_PRUNE)
        hold_topk(eng.search(qs, TOP_K, prune=REFINE_PRUNE, mode="refine",
                             refine_factor=cover), exact,
                  f"{precision} refine at the covering factor {cover}")
        out["recall_by_nprobe"] = {}
        for nprobe in NPROBES:
            res = eng.search(qs, TOP_K, prune="ivf+wcd+rwmd", nprobe=nprobe)
            out["recall_by_nprobe"][str(nprobe or "all")] = {
                "recall": recall(res, ex), "solved": res.solved.tolist()}
        vals = [v["recall"] for v in out["recall_by_nprobe"].values()]
        monotone(vals, f"{precision} nprobe")
        if vals[-1] != 1.0:
            raise AssertionError(f"{precision}: recall {vals[-1]} at "
                                 "nprobe=all")
        out["recall_by_refine_factor"] = {}
        for rf in REFINE_FACTORS + (cover,):
            res = eng.search(qs, TOP_K, prune=REFINE_PRUNE, mode="refine",
                             refine_factor=rf)
            out["recall_by_refine_factor"][str(rf)] = {
                "recall": recall(res, ex), "solved": res.solved.tolist()}
        monotone([v["recall"] for v in
                  out["recall_by_refine_factor"].values()],
                 f"{precision} refine_factor")
        rec[precision] = out
        if precision == "log":
            torch.cuda.synchronize()
            ops.reset_launches()      # the path: one "ivf+wcd+rwmd" search
            eng.search(qs, TOP_K, prune="ivf+wcd+rwmd")
            torch.cuda.synchronize()
            rec["launches_per_search"] = ops.launches()
            for name in ("rwmd_min_cdist_subset",
                         "sinkhorn_fused_all_batched"):
                if rec["launches_per_search"][name] <= 0:
                    raise AssertionError(f"{name} was not launched by the "
                                         "cascade search")
            timings = {}
            for key, kw in (
                    ("exhaustive", dict(prune=None)),
                    ("rwmd", dict(prune="rwmd")),
                    ("ivf+wcd+rwmd", dict(prune="ivf+wcd+rwmd")),
                    ("ivf+wcd+rwmd_nprobe4", dict(prune="ivf+wcd+rwmd",
                                                  nprobe=4)),
                    ("ivf+pivot+wcd+rwmd", dict(prune="ivf+pivot+wcd+rwmd")),
                    ("refine_4", dict(prune=REFINE_PRUNE, mode="refine",
                                      refine_factor=4))):
                eng.search(qs, TOP_K, **kw)                # warm-up
                timings[key] = wall_ms(lambda kw=kw: eng.search(qs, TOP_K,
                                                                **kw))
            rec["wall_ms_log"] = timings
            rec["median_ms_log"] = {key: v["median"]
                                    for key, v in timings.items()}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def phase_k2s_from_search(index, batches, label: str) -> dict:
    """K2s at the shapes the cascade gives it: the inputs of the widest
    RWMD stage among real log-domain "ivf+wcd+rwmd" searches, one of
    each query batch in ``batches``."""
    t0 = time.perf_counter()
    eng = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                    precision="log")
    casc = CapturingCascade(stages=("wcd", "rwmd"))
    for qs in batches:
        eng.search(qs, TOP_K, prune=casc)
    if not casc.calls:
        raise AssertionError("the cascade search made no K2s call")
    sup, mask, vids = max(casc.calls, key=lambda c: c[2].numel())
    rec = phase_k2s(index, sup, mask, vids, label)
    rec["calls_captured"] = len(casc.calls)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def phase_profile_cascade(corpus, index, reps: int = 5) -> None:
    """Where the time of an "ivf+wcd+rwmd" search of the dedup queries
    goes (log, lam=10), as phase ``profile`` reports the main path."""
    t0 = time.perf_counter()
    eng = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                    precision="log")
    out = profile_window(lambda: eng.search(list(corpus.queries), TOP_K,
                                            prune="ivf+wcd+rwmd"), reps)
    rec = profile_record("profile_cascade", *out, reps, precision="log",
                         lam=CONFIG.lam, prune="ivf+wcd+rwmd")
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


def phase_append(corpus, dev) -> None:
    """append_docs: an index built on the first APPEND_BASE dedup documents
    with the rest appended returns, for every query, the top-10 of a
    rebuild on all of them (nprobe=None)."""
    t0 = time.perf_counter()
    docs = corpus.docs
    head = PaddedDocs(idx=docs.idx[:APPEND_BASE], val=docs.val[:APPEND_BASE])
    tail = PaddedDocs(idx=docs.idx[APPEND_BASE:], val=docs.val[APPEND_BASE:])
    base = build_index(head, corpus.vecs, device=dev, n_clusters="auto")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    appended = append_docs(base, tail)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t1
    rebuilt = build_index(docs, corpus.vecs, device=dev, n_clusters="auto")
    qs = list(corpus.queries)
    rec = {"phase": "append", "base_docs": APPEND_BASE,
           "appended_docs": int(tail.idx.shape[0]),
           "n_clusters": appended.clusters.n_clusters,
           "append_seconds": append_s}
    for prune in ("ivf+wcd+rwmd", "rwmd"):
        got, want = (WmdEngine(ix, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                               precision="log").search(qs, TOP_K, prune=prune)
                     for ix in (appended, rebuilt))
        hold_topk(got, want, f"append then {prune} vs rebuild")
        rec[f"max_dist_rel_diff_{prune}"] = float(np.max(
            np.abs(got.distances - want.distances) / np.abs(want.distances)))
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


def k1_inputs(index, sup, mask, lam: float, log_domain: bool = False,
              gemm: str = "fp32"):
    """K1's G and val for a staged chunk against every document of the
    index, as the engine gathers them (N padded to a power of two)."""
    grp = index.subset(np.arange(index.n_docs, dtype=np.int32),
                       storage=True)
    kq = _compute_kq(sup, mask, index.vecs, index.vecs_sq, lam, gemm=gemm,
                     log_domain=log_domain)
    return _gather_g(kq, grp.docs.idx), grp.docs.val


def solve_bound(rows, val, counts, n_blocks: int) -> tuple[float, str]:
    """K1's (K4's) bound from this run's data: G at live (query row, doc
    slot) pairs read once, val at live slots, r, the outputs; per live
    pair 4 flops per realized iteration of its doc (``counts`` (Q, N)),
    plus the last SDDMM and the distance line. rows (Q,) live query rows,
    val (N, L)."""
    slots = (val > 0).sum(dim=1).double()
    rows = rows.double()
    q, n = counts.shape
    n_bytes = 4.0 * (float(rows.sum() * slots.sum()) + float(slots.sum())
                     + float(rows.numel()) + q * n + q * n_blocks)
    pairs = rows[:, None] * slots[None, :]
    n_flops = float((pairs * (4.0 * counts.double() + 4.0)).sum())
    return bound_ms(n_bytes, n_flops)


def phase_k1_adaptive(index, sup, r, mask, label: str) -> dict:
    """K1's adaptive exit on one staged chunk at fig10's operating point:
    tol=0 at the cap against fixed mode, tol=3e-2 against the plain
    version (distances and per-block counts), the resmask contract, and
    device time fixed against adaptive with the bounds from the realized
    per-document counts."""
    lam, n_iter = FIG10["lam"], FIG10["n_iter"]
    tol, ce = FIG10["tol"], FIG10["check_every"]
    g, val = k1_inputs(index, sup, mask, lam)
    q, _, n, _ = g.shape

    def fixed():
        return ops.sinkhorn_fused_all_batched(g, val, r, lam, n_iter,
                                              with_iters=True)

    def adaptive(t=tol, resmask=None):
        return ops.sinkhorn_fused_all_batched(
            g, val, r, lam, n_iter, tol=t, check_every=ce, resmask=resmask,
            with_iters=True)

    w_fix, _ = fixed()
    w_cap, it_cap = adaptive(0.0)
    w_ad, it_ad = adaptive()
    torch.cuda.synchronize()
    # tol=0 stops only a doc whose residual is exactly 0 (an fp32 fixed
    # point, or an empty scope: pad docs, filler queries); every other doc
    # runs to the cap, and the distances are fixed mode's
    live_docs = (val > 0).any(dim=1)
    live_q = mask.sum(dim=1) > 0
    cap_diff = float(((w_cap - w_fix).abs() / w_fix.abs().clamp(min=1e-30))
                     [live_q][:, live_docs].max())
    if cap_diff > 1e-6:
        raise AssertionError(f"K1 tol=0 at the cap differs from fixed mode "
                             f"by {cap_diff} relative (limit 1e-6)")
    held = ref.hold_solve(w_ad, it_ad, g, val, r, lam, n_iter, K1_RTOL,
                          K1_ATOL, tol=tol, check_every=ce)
    w1, i1 = adaptive(resmask=torch.ones((q, n), device=g.device))
    w0, i0 = adaptive(resmask=torch.zeros((q, n), device=g.device))
    torch.cuda.synchronize()
    # bit for bit, NaN where NaN (a filler query's linear-domain rows)
    if not (torch.equal(w1.isnan(), w_ad.isnan())
            and torch.equal(w1.nan_to_num(), w_ad.nan_to_num())
            and torch.equal(i1, it_ad)):
        raise AssertionError("K1: an all-ones resmask changed the result")
    if not (i0 == 1 + ce).all():
        raise AssertionError(f"K1: an empty scope did not stop at the "
                             f"first check ({1 + ce})")
    _, counts, _ = ref.solve_per_doc_ref(g, val, r, lam, n_iter, tol=tol,
                                         check_every=ce)
    rows = mask.sum(dim=1)
    nb = it_ad.shape[1]
    bms, by = solve_bound(rows, val, counts, nb)
    fix_bms, fix_by = solve_bound(rows, val, torch.full_like(counts, n_iter),
                                  nb)
    rec = {"phase": "k1_adaptive", "name": "sinkhorn_fused_all_batched",
           "inputs": label, **FIG10,
           "shape": {"Q": q, "v_r": g.shape[1], "N": n, "L": g.shape[3],
                     "live_docs": int(live_docs.sum()),
                     "live_rows": int(rows.sum())},
           "cap_equals_fixed_max_rel_diff": cap_diff,
           "cap_blocks_before_cap": int((it_cap[live_q] < n_iter).sum()),
           **held,
           "rtol": K1_RTOL, "atol": K1_ATOL,
           "mean_live_doc_iters": float(counts[:, live_docs].float().mean()),
           "empty_scope_iters": 1 + ce,
           "ms": time_ms(adaptive), "launch_ms": launch_ms(adaptive),
           "fixed_ms": time_ms(fixed),
           "plain_ms": time_ms(lambda: ref.sinkhorn_fused_all_batched_ref(
               g, val, r, lam, n_iter, tol=tol, check_every=ce),
               reps=3, warmup=1),
           "bound_ms": bms, "bound_by": by, "fixed_bound_ms": fix_bms,
           "fixed_bound_by": fix_by, "library_ms": None,
           "library": "none: no single PyTorch call computes a Sinkhorn "
                      "solve"}
    emit(rec)
    return rec


def phase_k1_bf16(index, sup, r, mask) -> dict:
    """K1 with bf16 operands against its plain version: fixed at lam=1
    (fp32 K) and lam=10 (log domain), and adaptive at fig10's point."""
    rec = {"phase": "k1_bf16", "name": "sinkhorn_fused_all_batched",
           "gemm": "bf16", "rtol": K1_RTOL, "atol": K1_ATOL}
    for key, lam, log_domain, opts in (
            ("fixed_lam1", 1.0, False, {}),
            ("fixed_log_lam10", CONFIG.lam, True, {}),
            ("adaptive_fig10", FIG10["lam"], False,
             dict(tol=FIG10["tol"], check_every=FIG10["check_every"]))):
        g, val = k1_inputs(index, sup, mask, lam, log_domain, "bf16")
        n_iter = CONFIG.n_iter

        def kernel():
            return ops.sinkhorn_fused_all_batched(
                g, val, r, lam, n_iter, gemm="bf16", log_domain=log_domain,
                with_iters=True, **opts)

        got, it = kernel()
        torch.cuda.synchronize()
        held = ref.hold_solve(got, it, g, val, r, lam, n_iter, K1_RTOL,
                              K1_ATOL, gemm="bf16", log_domain=log_domain,
                              **opts)
        _, counts, _ = ref.solve_per_doc_ref(g, val, r, lam, n_iter,
                                             log_domain, gemm="bf16",
                                             **opts)
        bms, by = solve_bound(mask.sum(dim=1), val, counts, it.shape[1])
        rec["shape"] = list(g.shape)
        rec[key] = {"lam": lam, "log_domain": log_domain, **opts, **held,
                    "ms": time_ms(kernel), "launch_ms": launch_ms(kernel),
                    "plain_ms": time_ms(
                        lambda: ref.sinkhorn_fused_all_batched_ref(
                            g, val, r, lam, n_iter, log_domain=log_domain,
                            gemm="bf16", **opts), reps=3, warmup=1),
                    "bound_ms": bms, "bound_by": by}
        del g
    emit(rec)
    return rec


def phase_k3_bf16(vecs, a, r) -> list[dict]:
    """K3 with bf16 operands in its three modes, held in squared distance
    as the fp32 kernel is (P1)."""
    recs = []
    v_r, w = a.shape
    v = vecs.shape[0]
    for mode, lam, k_only, log_k in (("k_only", FIG10["lam"], True, False),
                                     ("full", 1.0, False, False),
                                     ("log_k", CONFIG.lam, True, True)):
        def kernel():
            return ops.cdist_exp(a, vecs, r, lam, k_only=k_only, log_k=log_k,
                                 gemm="bf16")

        def plain():
            return ref.cdist_exp_ref(a, vecs, r, lam, k_only=k_only,
                                     log_k=log_k, gemm="bf16")

        got = kernel()
        torch.cuda.synchronize()
        errs = ref.hold_cdist_exp(got, a, vecs, r, lam, k_only, log_k,
                                  gemm="bf16")
        del got
        bms, by = k3_bound(v_r, w, v, 1 if k_only else 3)
        rec = {"phase": "k3_bf16", "name": "cdist_exp", "gemm": "bf16",
               "mode": mode, "lam": lam,
               "shape": {"v_r": v_r, "w": w, "V": v}, **errs,
               "sq_rtol": ref.K3_SQ_RTOL, "ms": time_ms(kernel),
               "launch_ms": launch_ms(kernel),
               "plain_ms": time_ms(plain, reps=5, warmup=1),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "library": "none: no single PyTorch call computes "
                          "exp(-lam*cdist); torch.cdist gives M alone"}
        emit(rec)
        recs.append(rec)
    return recs


def phase_k4_adaptive(vecs, docs, r, vecs_sel) -> dict:
    """K4 on one paper query's G against every document: the adaptive exit
    at fig10's point (with a resmask on every other document) and bf16
    operands (fixed and adaptive), each against its plain version."""
    lam, n_iter = FIG10["lam"], FIG10["n_iter"]
    opts = dict(tol=FIG10["tol"], check_every=FIG10["check_every"])
    rec = {"phase": "k4_adaptive", "name": "sinkhorn_fused_all", **FIG10,
           "rtol": K4_RTOL, "atol": K4_ATOL}
    n = docs.val.shape[0]
    half = (torch.arange(n, device=vecs.device) % 2 == 0).float()
    for key, gemm, kw in (("adaptive", "fp32", opts),
                          ("adaptive_resmask", "fp32",
                           dict(opts, resmask=half)),
                          ("bf16_fixed", "bf16", {}),
                          ("bf16_adaptive", "bf16", opts)):
        k = ref.cdist_exp_ref(vecs_sel, vecs, r, lam, k_only=True, gemm=gemm)
        g = gather_columns(k, docs.idx)

        def kernel():
            return ops.sinkhorn_fused_all(g, docs.val, r, lam, n_iter,
                                          gemm=gemm, with_iters=True, **kw)

        got, it = kernel()
        torch.cuda.synchronize()
        held = ref.hold_solve(got, it, g, docs.val, r, lam, n_iter, K4_RTOL,
                              K4_ATOL, gemm=gemm, **dict(kw))
        rm = kw.get("resmask")
        _, counts, _ = ref.solve_per_doc_ref(
            g[None], docs.val, r[None], lam, n_iter, gemm=gemm,
            tol=kw.get("tol"), check_every=FIG10["check_every"],
            resmask=None if rm is None else rm[None])
        bms, by = solve_bound(torch.tensor([float(g.shape[0])],
                                           device=g.device),
                              docs.val, counts, it.shape[0])
        rec[key] = {"gemm": gemm, "resmask": rm is not None, **held,
                    "ms": time_ms(kernel), "launch_ms": launch_ms(kernel),
                    "plain_ms": time_ms(lambda: ref.sinkhorn_fused_all_ref(
                        g, docs.val, r, lam, n_iter, gemm=gemm, **kw),
                        reps=3, warmup=1),
                    "bound_ms": bms, "bound_by": by}
    rec["shape"] = {"v_r": g.shape[0], "N": n, "L": g.shape[2],
                    "live_slots": int((docs.val > 0).sum())}
    emit(rec)
    return rec


def phase_one_query_adaptive(corpus, dev) -> dict:
    """The one-query kernel path (K3 -> gather -> K4) under tol and with
    bf16 operands, on the widest paper query, against the sparse solver
    with the same arguments, and the launches of each path."""
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    docs = device_docs(corpus.docs, dev)
    r, sel, _ = select_support(widest_query(corpus), vecs)
    lam, n_iter = FIG10["lam"], FIG10["n_iter"]
    adaptive = dict(tol=FIG10["tol"], check_every=FIG10["check_every"])
    rec = {"phase": "one_query_adaptive", **FIG10, "launches": {},
           "max_rel_gap": {}, "rtol": {}}
    for key, kw, rtol in (("adaptive", adaptive, P3_RTOL),
                          ("bf16", dict(precision="bf16"), BF16_P1_RTOL),
                          ("bf16_adaptive", dict(adaptive, precision="bf16"),
                           P3_RTOL)):
        torch.cuda.synchronize()
        ops.reset_launches()              # the path: one kernel-path call
        got = ops.sinkhorn_wmd_kernel(r, sel, vecs, docs, lam, n_iter, **kw)
        torch.cuda.synchronize()
        rec["launches"][key] = ops.launches()
        for name in ("cdist_exp", "sinkhorn_fused_all"):
            if rec["launches"][key][name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     f"{key} kernel path")
        want = sinkhorn_wmd_sparse(r, sel, vecs, docs, lam, n_iter, **kw)
        rec["max_rel_gap"][key] = compare(got, want, rtol, 1e-4,
                                          f"one query {key}")[1]
        rec["rtol"][key] = rtol
    emit(rec)
    return rec


def topk_tolerant(d_fixed, res, band: float, label: str) -> float:
    """fig10's gate: every returned doc's fixed-mode distance is within
    ``band`` (2*tol; BF16_RTOL for bf16) of the fixed-mode k-th distance
    (near-ties may flip at the solve tolerance; nothing outside the band
    may appear). Returns the worst returned doc's excess over the k-th
    distance, relative."""
    worst_rel = 0.0
    for qi in range(d_fixed.shape[0]):
        kth = np.sort(d_fixed[qi])[TOP_K - 1]
        worst = d_fixed[qi, res.indices[qi]].max()
        if worst > kth * (1.0 + band) + 1e-3:
            raise AssertionError(f"{label} q{qi}: a returned doc lies "
                                 f"outside {band} of the fixed top-{TOP_K}")
        worst_rel = max(worst_rel, float(worst / kth - 1.0))
    return worst_rel


def phase_adaptive(corpus, index) -> dict:
    """The adaptive solve through search on the dedup corpus at the
    paper's widths: at fig10's three operating points, scope "query" and
    "chunk", full-sweep RWMD and the cascade; the staged top-10 equals
    the exhaustive top-10 under the same tol, every returned doc lies in
    fig10's 2*tol band of the fixed-mode top-10, bf16 and bf16+log stay
    within BF16_RTOL of fp32; realized counts per stage and latency fixed
    against adaptive."""
    t0 = time.perf_counter()
    qs = list(corpus.queries)
    rec = {"phase": "adaptive", "n_docs": index.n_docs, "queries": len(qs),
           "k": TOP_K, "points": {}}
    for name, point in (("fig10", FIG10), ("pq_lam1", PQ),
                        ("pq_log_lam10", PQ_LOG)):
        base = {k: v for k, v in point.items()
                if k in ("lam", "n_iter", "precision")}
        fixed = WmdEngine(index, **base)
        d_fixed = fixed.query_batch(qs).numpy()
        out = {"stages": {}, "band_worst_rel": {}, "solved": {}}
        for scope in ("query", "chunk"):
            eng = WmdEngine(index, scope=scope, **point)
            full = eng.query_batch(qs).numpy()
            ex_i = np.argsort(full, axis=1, kind="stable")[:, :TOP_K]
            ex_d = np.take_along_axis(full, ex_i, axis=1)
            for prune in ("rwmd", "ivf+wcd+rwmd"):
                eng.reset_iter_stats()
                res = eng.search(qs, TOP_K, prune=prune)
                label = f"{name} {scope} {prune}"
                if not np.array_equal(res.indices, ex_i):
                    raise AssertionError(f"{label}: staged top-{TOP_K} ids "
                                         "differ from the exhaustive top-"
                                         f"{TOP_K} under the same tol")
                np.testing.assert_allclose(res.distances, ex_d,
                                           rtol=E2E_RTOL, atol=0,
                                           err_msg=label)
                out["band_worst_rel"][f"{scope} {prune}"] = topk_tolerant(
                    d_fixed, res, 2.0 * point["tol"], label)
                out["solved"][f"{scope} {prune}"] = res.solved.tolist()
                out["stages"][f"{scope} {prune}"] = {
                    st: {"mean": float(a.mean()), "max": int(a.max()),
                         "n": int(a.size)}
                    for st, a in eng.iter_stats_by_stage().items()}
        rec["points"][name] = {**point, **out}
    # bf16 and bf16+log at fig10's point against the fixed fp32 engine,
    # as fig10 holds them: the search's returned docs within BF16_RTOL of
    # the fp32 top-10, every distance within BF16_W300_RTOL (R6)
    d32 = WmdEngine(index, lam=FIG10["lam"],
                    n_iter=FIG10["n_iter"]).query_batch(qs).numpy()
    rec["bf16"] = {"band": BF16_RTOL, "rtol": BF16_W300_RTOL}
    for precision in ("bf16", "bf16+log"):
        eng = WmdEngine(index, precision=precision, **FIG10)
        d = eng.query_batch(qs).numpy()
        out = {"max_rel_diff": float(np.max(np.abs(d - d32) / np.abs(d32)))}
        for prune in ("rwmd", "ivf+wcd+rwmd"):
            res = eng.search(qs, TOP_K, prune=prune)
            out[f"band_worst_rel {prune}"] = topk_tolerant(
                d32, res, BF16_RTOL, f"{precision} {prune}")
            out[f"top10_max_rel_diff {prune}"] = float(np.max(np.abs(
                res.distances - np.take_along_axis(d32, res.indices, 1))
                / np.take_along_axis(d32, res.indices, 1)))
        rec["bf16"][precision] = out
        np.testing.assert_allclose(d, d32, rtol=BF16_W300_RTOL, atol=1e-3,
                                   err_msg=precision)
    # the path: one adaptive "ivf+wcd+rwmd" search, launches counted
    eng = WmdEngine(index, **FIG10)
    eng.search(qs, TOP_K, prune="ivf+wcd+rwmd")          # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    eng.search(qs, TOP_K, prune="ivf+wcd+rwmd")
    torch.cuda.synchronize()
    rec["launches_per_search"] = ops.launches()
    if rec["launches_per_search"]["sinkhorn_fused_all_batched"] <= 0:
        raise AssertionError("K1 was not launched by the adaptive search")
    # latency, fixed against adaptive, fig10's point, both prune specs
    timings = {}
    for prune in ("rwmd", "ivf+wcd+rwmd"):
        for key, e in (("fixed", WmdEngine(index, lam=FIG10["lam"],
                                           n_iter=FIG10["n_iter"])),
                       ("adaptive", eng)):
            e.search(qs, TOP_K, prune=prune)             # warm-up
            timings[f"{key} {prune}"] = wall_ms(
                lambda e=e, prune=prune: e.search(qs, TOP_K, prune=prune))
    rec["wall_ms"] = timings
    rec["median_ms"] = {k: v["median"] for k, v in timings.items()}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


# ------------------------------------------------- slice 5: K6, einsum
def bsr_bound(v: int, v_r: int, n: int, nb: int, bv: int, bn: int,
              panels: bool) -> tuple[float, str]:
    """K6's bound: c's retained tiles read once and w written once, the
    operands (kt and u, or with ``panels`` the gathered (nb, bv, v_r) and
    (nb, v_r, bn) panels) and the tile coordinates read once; 2 v_r + 1
    flops per tile element (the product and the c multiply)."""
    elems = float(nb) * bv * bn
    operands = (nb * (bv * v_r + v_r * bn) if panels
                else v * v_r + v_r * n)
    n_bytes = 4.0 * (2.0 * elems + operands) + 8.0 * nb
    return bound_ms(n_bytes, elems * (2.0 * v_r + 1.0))


def phase_k6(vecs, docs, r, vecs_sel) -> dict:
    """K6 at the paper corpus: c the doc matrix (V, N) on the card, kt K3's
    K of the widest paper query transposed (V, v_r), u 1/x of that query's
    sparse solve after n_iter iterations at lam=1, padded to whole tiles;
    128 x 128 and 64 x 64 tiles. Each tile size: the path (one
    ``ops.bsr_sddmm`` call, launches counted), both entry points held
    against the plain version at the reference's 1e-5 of |c| (|kt| |u|),
    times, the bound, and the dense ``c * (kt @ u)`` beside them."""
    from repro_torch.core.sparse import (block_density,
                                         block_sparse_from_dense,
                                         padded_docs_to_dense)
    v = vecs.shape[0]
    n = docs.idx.shape[0]
    c = padded_docs_to_dense(docs, v)                            # (V, N)
    kt = ops.cdist_exp(vecs_sel, vecs, r, 1.0, k_only=True).T.contiguous()
    x = _iterate(precompute_sparse(r, vecs_sel, vecs, docs, 1.0),
                 CONFIG.n_iter)
    u_n = ref._safe_inv(x)                                       # (v_r, N)
    v_r = u_n.shape[0]
    recs = {}
    for bv, bn in ((128, 128), (64, 64)):
        cb = block_sparse_from_dense(c, bv, bn)
        nb = cb.blocks.shape[0]
        u = torch.nn.functional.pad(u_n, (0, cb.shape[1] - n)).contiguous()
        ops.reset_launches()                      # the path: one call
        w = ops.bsr_sddmm(kt, u, cb)
        torch.cuda.synchronize()
        launches = ops.launches()["bsr_sddmm_blocks"]
        if launches != 1:
            raise AssertionError(f"bsr_sddmm launched K6 {launches} times")
        ktb, ub = ref.bsr_panels(kt, u, cb.brow, cb.bcol, bv, bn)
        ktb, ub = ktb.contiguous(), ub.contiguous()
        errs = ref.hold_bsr_sddmm(w, ktb, ub, cb.blocks)
        del w
        blk_errs = ref.hold_bsr_sddmm(ops.bsr_sddmm_blocks(ktb, ub,
                                                           cb.blocks),
                                      ktb, ub, cb.blocks)

        def kernel(cb=cb, u=u):
            return ops.bsr_sddmm(kt, u, cb)

        def blocks(cb=cb, ktb=ktb, ub=ub):
            return ops.bsr_sddmm_blocks(ktb, ub, cb.blocks)

        def plain(cb=cb, u=u, bv=bv, bn=bn):
            return ref.bsr_sddmm_blocks_ref(
                *ref.bsr_panels(kt, u, cb.brow, cb.bcol, bv, bn), cb.blocks)

        def dense():
            return c * (kt @ u_n)

        bms, by = bsr_bound(v, v_r, cb.shape[1], nb, bv, bn, panels=False)
        bbms, bby = bsr_bound(v, v_r, cb.shape[1], nb, bv, bn, panels=True)
        rec = {"phase": "k6", "name": "bsr_sddmm_blocks",
               "tile": [bv, bn],
               "shape": {"V": v, "N": n, "v_r": v_r, "blocks": nb,
                         "all_tiles": (cb.shape[0] // bv)
                         * (cb.shape[1] // bn)},
               "block_density": block_density(c, bv, bn),
               "retained_gb": 4.0 * nb * bv * bn / 1e9,
               "dense_c_gb": 4.0 * v * n / 1e9,
               **errs, "rtol_of_scale": ref.K6_RTOL,
               "launches": launches, "ms": time_ms(kernel),
               "launch_ms": launch_ms(kernel),
               "plain_ms": time_ms(plain, reps=5, warmup=1),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "library": "none: no single PyTorch call computes a "
                          "block-sparse SDDMM",
               "dense_ms": time_ms(dense, reps=5, warmup=1),
               "dense": "c * (kt @ u) over the whole (V, N): two calls, "
                        "a comparison, not the same function's cost",
               "blocks_entry": {**blk_errs, "ms": time_ms(blocks),
                                "bound_ms": bbms, "bound_by": bby}}
        emit(rec)
        recs[f"{bv}x{bn}"] = rec
        del cb, ktb, ub
        torch.cuda.empty_cache()
    return recs


def wide_docs(index, dev, n: int, length: int, seed: int):
    """``n`` synthetic docs of ``length`` distinct paper-vocabulary words
    each (random frequencies, a few pad slots): the long documents no
    paper doc is, for tiles over the shared-memory limit."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(index.vocab_size, length, replace=False)
                    for _ in range(n)])
    val = rng.random((n, length)) + 0.05
    val[:, length - 7:] = 0.0
    val /= val.sum(1, keepdims=True)
    return (torch.as_tensor(idx, dtype=torch.int64, device=dev),
            torch.as_tensor(val, dtype=torch.float32, device=dev))


def phase_k1_over_limit(index, dev) -> dict:
    """K1 with a (v_r, L) tile over the card's 227 KB of shared memory:
    256 query rows against 384 docs of 256 slots (263 KB), which
    ``tile="auto"`` runs on the variant that reads G from device memory;
    fp32 at lam=1 and log at lam=10, fixed and adaptive, and K4 on one
    query's tile, each held against the plain version; timed beside the shared-memory variant at
    the same Q and N on 192-row, 192-slot tiles (both variants there)."""
    sup, r, mask = paper_chunk(index.vocab_size, dev, width=256, q=2,
                               seed=6)
    idx, val = wide_docs(index, dev, 384, 256, seed=7)
    rec = {"phase": "k1_wide", "case": "over_smem_limit", "Q": 2, "N": 384,
           "cases": {}}
    for log_domain, lam in ((False, 1.0), (True, CONFIG.lam)):
        kq = _compute_kq(sup, mask, index.vecs, index.vecs_sq, lam,
                         log_domain=log_domain)
        g = _gather_g(kq, idx)                        # (2, 256, 384, 256)
        key = "log" if log_domain else "fp32"
        for mode, kw in (("fixed", {}),
                         ("adaptive", dict(tol=1e-2, check_every=2))):
            got, it = ops.sinkhorn_fused_all_batched(
                g, val, r, lam, CONFIG.n_iter, log_domain=log_domain,
                with_iters=True, **kw)
            torch.cuda.synchronize()
            held = ref.hold_solve(got, it, g, val, r, lam, CONFIG.n_iter,
                                  K1_RTOL, K1_ATOL, log_domain=log_domain,
                                  **kw)

            def run(kw=kw, g=g, log_domain=log_domain, lam=lam):
                return ops.sinkhorn_fused_all_batched(
                    g, val, r, lam, CONFIG.n_iter, log_domain=log_domain,
                    **kw)

            rec["cases"][f"{key} {mode}"] = {
                "shape": list(g.shape), **held, "ms": time_ms(run)}
        # K4 (K1's entry point at Q = 1) on the first query's tile
        got4 = ops.sinkhorn_fused_all(g[0], val, r[0], lam, CONFIG.n_iter,
                                      log_domain=log_domain)
        torch.cuda.synchronize()
        want4 = ref.sinkhorn_fused_all_ref(g[0], val, r[0], lam,
                                           CONFIG.n_iter,
                                           log_domain=log_domain)[0]
        rec["cases"][f"{key} K4"] = {"max_abs_err": compare(
            got4, want4, K4_RTOL, K4_ATOL, f"K4 over the limit {key}")[0]}
        # the two variants at one shape both fit: 192 x 192 (145 KB)
        g2 = _gather_g(kq[:, :192], idx[:, :192]).contiguous()
        v2 = (val[:, :192] / val[:, :192].sum(1, keepdim=True)).contiguous()
        r2 = r[:, :192].contiguous()
        want = ref.sinkhorn_fused_all_batched_ref(
            g2, v2, r2, lam, CONFIG.n_iter, log_domain=log_domain)[0]
        for tile in ("shared", "global"):
            def run2(tile=tile, g2=g2, lam=lam, log_domain=log_domain):
                return ops.sinkhorn_fused_all_batched(
                    g2, v2, r2, lam, CONFIG.n_iter, log_domain=log_domain,
                    tile=tile)
            abs_err, _ = compare(run2(), want, K1_RTOL, K1_ATOL,
                                 f"K1 192x192 tile={tile} {key}")
            rec["cases"][f"{key} 192x192 {tile}"] = {
                "max_abs_err": abs_err, "ms": time_ms(run2)}
        del kq, g, g2
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def phase_einsum(corpus, index) -> dict:
    """The einsum engine (``impl="sparse"``) at the paper's widths:
    ``query_batch`` and ``search(k=10, prune="rwmd")`` in fp32 at lam=1
    and in log at lam=10. The staged top-10 equals the exhaustive top-10;
    the distances are held against the kernel impl at
    ``tests/test_engine.py``'s rtol = atol = 5e-4 (the two share the K
    block's inputs; they differ in the K block's GEMM shape and in the
    distance line); latency beside the kernel impl's."""
    qs = list(corpus.queries)
    rec = {"phase": "einsum", "queries": len(qs), "k": TOP_K,
           "points": {}}
    for precision, lam in (("fp32", 1.0), ("log", CONFIG.lam)):
        kw = dict(lam=lam, n_iter=CONFIG.n_iter, precision=precision)
        sp, kn = (WmdEngine(index, impl="sparse", **kw),
                  WmdEngine(index, impl="kernel", **kw))
        sp.search(qs, TOP_K, prune="rwmd")                 # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        res = sp.search(qs, TOP_K, prune="rwmd")
        torch.cuda.synchronize()
        launches = ops.launches()
        full = sp.query_batch(qs).numpy()
        full_k = kn.query_batch(qs).numpy()
        if np.isnan(full).any():
            raise AssertionError(f"einsum {precision}: NaN distances")
        ex_i = np.argsort(full, axis=1, kind="stable")[:, :TOP_K]
        if not np.array_equal(res.indices, ex_i):
            raise AssertionError(f"einsum {precision}: staged top-{TOP_K} "
                                 "differs from the exhaustive top-10")
        np.testing.assert_allclose(
            res.distances, np.take_along_axis(full, ex_i, 1),
            rtol=E2E_RTOL, atol=0, err_msg=f"einsum {precision}")
        gap = np.abs(full - full_k)
        np.testing.assert_allclose(full, full_k, rtol=EINSUM_RTOL,
                                   atol=EINSUM_RTOL,
                                   err_msg=f"einsum vs kernel {precision}")
        if launches["rwmd_min_cdist"] <= 0 or \
                launches["sinkhorn_fused_all_batched"] != 0:
            raise AssertionError(f"einsum search launched {launches}")
        kn.search(qs, TOP_K, prune="rwmd")                 # warm-up
        rec["points"][precision] = {
            "lam": lam, "launches": launches,
            "max_abs_diff_vs_kernel": float(gap.max()),
            "max_rel_diff_vs_kernel": float((gap / np.abs(full_k)).max()),
            "rtol": EINSUM_RTOL, "solved": res.solved.tolist(),
            "search_ms": wall_ms(lambda: sp.search(qs, TOP_K,
                                                   prune="rwmd")),
            "kernel_search_ms": wall_ms(lambda: kn.search(qs, TOP_K,
                                                          prune="rwmd")),
            "query_batch_ms": wall_ms(lambda: sp.query_batch(qs)),
            "kernel_query_batch_ms": wall_ms(lambda: kn.query_batch(qs))}
        for key in ("search_ms", "kernel_search_ms", "query_batch_ms",
                    "kernel_query_batch_ms"):
            rec["points"][precision][key + "_median"] = \
                rec["points"][precision][key]["median"]
    emit(rec)
    return rec


def phase_warm_start(corpus, index) -> dict:
    """warm_start on the einsum impl, on the dedup corpus at fig10's point
    (lam=0.25, tol=3e-2, check_every=2, cap 15, scope="query"): warm
    survivors take no more realized iterations than cold ones, the seed
    stage is the same, the top-10 distances hold within
    ``tests/test_convergence_scoped.py``'s band (rtol 5e-2, atol 1e-3);
    without tol warm equals cold bit for bit."""
    qs = list(corpus.queries)
    rec = {"phase": "warm_start", **FIG10, "scope": "query", "prunes": {}}
    for prune in ("rwmd", "ivf+wcd+rwmd"):
        out = {}
        for warm in (False, True):
            eng = WmdEngine(index, impl="sparse", scope="query",
                            warm_start=warm, **FIG10)
            res = eng.search(qs, TOP_K, prune=prune)
            out[warm] = (res, eng.iter_stats_by_stage())
        (r_c, s_c), (r_w, s_w) = out[False], out[True]
        np.testing.assert_allclose(np.sort(r_w.distances, axis=1),
                                   np.sort(r_c.distances, axis=1),
                                   rtol=5e-2, atol=1e-3, err_msg=prune)
        if not np.array_equal(s_w["seed"], s_c["seed"]):
            raise AssertionError(f"{prune}: warm start moved the seeds")
        if "survivor" in s_c and \
                s_w["survivor"].mean() > s_c["survivor"].mean():
            raise AssertionError(f"{prune}: warm survivors took more "
                                 "iterations than cold ones")
        rec["prunes"][prune] = {
            f"{k}_{st}": {"mean": float(a.mean()), "max": int(a.max())}
            for k, stages in (("cold", s_c), ("warm", s_w))
            for st, a in stages.items()}
        rec["prunes"][prune]["top10_equal"] = bool(
            np.array_equal(np.sort(r_w.indices, 1), np.sort(r_c.indices, 1)))
    fixed = [WmdEngine(index, impl="sparse", lam=FIG10["lam"],
                       n_iter=FIG10["n_iter"], warm_start=warm)
             .search(qs, TOP_K, prune="rwmd") for warm in (False, True)]
    if not (np.array_equal(fixed[0].indices, fixed[1].indices)
            and np.array_equal(fixed[0].distances, fixed[1].distances)):
        raise AssertionError("warm_start changed a search without tol")
    rec["inert_without_tol"] = True
    emit(rec)
    return rec


def kcache_loop(index, stream, slots: int, prune: str = KCACHE_PRUNE,
                batch: int = 8) -> dict:
    """fig15's closed loop: a fresh cached engine (fp32, lam=1,
    kcache_min_hits=1) warms on the stream's first 32 queries twice, then
    replays the whole stream in batches; the replay's counters."""
    eng = WmdEngine(index, lam=1.0, n_iter=CONFIG.n_iter, impl="sparse",
                    kcache_slots=slots, kcache_min_hits=1)
    for _ in range(2):
        for i in range(0, 32, batch):
            eng.search(stream[i:i + batch], TOP_K, prune=prune)
    eng.reset_kcache_stats()
    for i in range(0, len(stream), batch):
        eng.search(stream[i:i + batch], TOP_K, prune=prune)
    return eng.kcache_stats()


def phase_kcache(corpus, index) -> dict:
    """The K-column cache on the paper corpus under fig15's traffic: 128
    queries of 32 Zipf (s=1.0) draws over the vocabulary, seed 11, batches
    of 8, ``prune="ivf+wcd+rwmd"``. Cache-on equals cache-off bit for bit,
    cold and warm, for search and query_batch, in every precision (512
    slots, ~205 MB); the closed-loop hit rate after warmup at 512 and
    1024 slots, and on fig15's own corpus (V=8192, w=64) at 512; the
    K block's time with and without the cache."""
    vocab = index.vocab_size
    stream = zipf_queries(128, vocab, words=32, s=1.0, seed=11)
    rec = {"phase": "kcache", "slots": KCACHE_SLOTS, "queries": 128,
           "words": 32, "zipf_s": 1.0, "prune": KCACHE_PRUNE,
           "store_mb": KCACHE_SLOTS * vocab * 4 / 1e6, "exact": {}}
    for precision in ("fp32", "bf16", "log", "bf16+log"):
        lam = CONFIG.lam if "log" in precision else 1.0
        kw = dict(lam=lam, n_iter=CONFIG.n_iter, impl="sparse",
                  precision=precision)
        off = WmdEngine(index, **kw)
        on = WmdEngine(index, kcache_slots=KCACHE_SLOTS, kcache_min_hits=1,
                       **kw)
        for pass_ in ("cold", "warm"):
            for i in range(0, 32, 8):
                chunk = stream[i:i + 8]
                a = off.search(chunk, TOP_K, prune=KCACHE_PRUNE)
                b = on.search(chunk, TOP_K, prune=KCACHE_PRUNE)
                qa, qb = off.query_batch(chunk), on.query_batch(chunk)
                label = f"kcache {precision} {pass_} batch {i}"
                if not (np.array_equal(a.indices, b.indices)
                        and np.array_equal(a.distances, b.distances)
                        and torch.equal(qa, qb)):
                    gap = float(np.nanmax(np.abs(a.distances - b.distances)))
                    raise AssertionError(f"{label}: cache-on differs from "
                                         f"cache-off (max gap {gap})")
        rec["exact"][precision] = {"bitwise": True,
                                   "stats": on.kcache_stats()}
    rec["hit_rate"] = {}
    for slots in (KCACHE_SLOTS, 2 * KCACHE_SLOTS):
        rec["hit_rate"][f"paper {slots}"] = kcache_loop(index, stream,
                                                        slots)["hit_rate"]
    fig = make_corpus(vocab_size=8192, embed_dim=64, n_docs=2048,
                      n_queries=8, seed=0)
    findex = build_index(fig.docs, fig.vecs, device=index.device)
    hr_fig = kcache_loop(findex, zipf_queries(128, 8192, words=32, s=1.0,
                                              seed=11),
                         KCACHE_SLOTS)["hit_rate"]
    rec["hit_rate"]["fig15 512"] = hr_fig
    for key, hr in (("fig15 512", hr_fig),
                    (f"paper {2 * KCACHE_SLOTS}",
                     rec["hit_rate"][f"paper {2 * KCACHE_SLOTS}"])):
        if not hr > 0.5:
            raise AssertionError(f"kcache {key}: closed-loop hit rate {hr} "
                                 "is not above 0.5")
    # the K block of one warm chunk, with and without the cache
    eng_on = WmdEngine(index, lam=1.0, n_iter=CONFIG.n_iter, impl="sparse",
                       kcache_slots=KCACHE_SLOTS, kcache_min_hits=1)
    eng_off = WmdEngine(index, lam=1.0, n_iter=CONFIG.n_iter,
                        impl="sparse")
    _, chunks = eng_on._plan(stream[:8])
    chunk, width = max(chunks, key=lambda c: (c[1], len(c[0])))
    sup, _, mask = eng_on._prep_chunk([stream[qi] for qi in chunk], width)
    eng_on._kq(sup, mask)                                 # warm the rows
    rec["k_block"] = {"Q": int(sup.shape[0]), "B": int(sup.shape[1]),
                      "cached_ms": wall_ms(lambda: eng_on._kq(sup, mask)),
                      "uncached_ms": wall_ms(lambda: eng_off._kq(sup, mask)),
                      "kernel_impl_ms": wall_ms(lambda: WmdEngine(
                          index, lam=1.0, impl="kernel")._kq(sup, mask))}
    for key in ("cached_ms", "uncached_ms", "kernel_impl_ms"):
        rec["k_block"][key + "_median"] = rec["k_block"][key]["median"]
    emit(rec)
    return rec


# ----------------------------------------------------------------- serving
def serve_requests(corpus, n: int, seed: int = 0):
    """``n`` requests of ``wmd_request_stream(corpus, seed)`` and each
    one's row in ``corpus.queries``."""
    stream = wmd_request_stream(corpus, seed)
    reqs = [next(stream) for _ in range(n)]
    ids = [next(i for i, q in enumerate(corpus.queries)
                if np.array_equal(q, r)) for r in reqs]
    return reqs, ids


def serve_capacity(engine, reqs, label: str, card: str,
                   batch: int = SERVE_BATCH) -> dict:
    """``engine.search`` on batches of ``batch`` requests, back to back
    (``prune=SERVE_PRUNE``, k=10): capacity = batch over the median of
    E2E_REPS warm calls, in requests per second."""
    batches = [reqs[i:i + batch]
               for i in range(0, len(reqs) - batch + 1, batch)]
    it = iter(batches * (E2E_REPS + 4))
    for _ in range(3):
        engine.search(next(it), TOP_K, prune=SERVE_PRUNE)    # warm-up
    t = wall_ms(lambda: engine.search(next(it), TOP_K, prune=SERVE_PRUNE))
    rec = {"phase": "serve_capacity", "engine": label, "card": card,
           "impl": engine.impl, "precision": engine.precision.name,
           "lam": engine.lam, "batch": batch, "prune": SERVE_PRUNE,
           "k": TOP_K, "search_ms": t,
           "capacity_per_s": batch / (t["median"] / 1e3)}
    emit(rec)
    return rec


def serve_run(engine, reqs, rate: float, cfg: ServeConfig, label: str,
              injector=None, tiers=None, failed=SERVE_FAILED):
    """One open-loop run through a fresh runtime (its dispatch thread is
    new too): ``reqs`` at Poisson arrivals of ``rate`` per second (seed 1).
    Returns (responses, stats, record); the record holds p50/p99 of
    queue + service time, throughput, the tier mix, the first dispatch's
    service time apart from the others', and K1/K2/K2s launches per
    dispatch. Raises on a response whose code is in ``failed``."""
    rt = ServingRuntime(engine, cfg, injector=injector, tiers=tiers)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    resps, stats = run_open_loop(rt, reqs, poisson_arrivals(
        len(reqs), rate, seed=1), k=TOP_K)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = ops.launches()
    if len(resps) != len(reqs):
        raise AssertionError(f"serve {label}: {len(resps)} responses for "
                             f"{len(reqs)} requests")
    codes = {}
    for r in resps:
        if not r.ok:
            codes[r.error["code"]] = codes.get(r.error["code"], 0) + 1
    bad = {c: n for c, n in codes.items() if c in failed}
    if bad:
        first = next(r for r in resps if not r.ok
                     and r.error["code"] in failed)
        raise AssertionError(f"serve {label}: failed dispatches {bad}: "
                             f"{first.error}")
    lat = np.asarray([r.queue_ms + r.service_ms for r in resps if r.ok])
    service, sizes = {}, {}
    for r in resps:
        if r.dispatch_id >= 0:
            service[r.dispatch_id] = r.service_ms
            sizes[r.dispatch_id] = r.batch_size
    rest = [ms for d, ms in service.items() if d != min(service)]
    n_disp = max(1, stats["dispatches"])
    rec = {"label": label, "requests": len(reqs), "rate_per_s": rate,
           "wall_s": wall, "answered": int(lat.size),
           "throughput_per_s": lat.size / wall,
           "latency_ms_p50": float(np.percentile(lat, 50)) if lat.size
           else None,
           "latency_ms_p99": float(np.percentile(lat, 99)) if lat.size
           else None,
           "tiers": stats["tiers"], "degraded_frac": stats["degraded_frac"],
           "rejected": stats["rejected"], "retries": stats["retries"],
           "errors": codes, "dispatches": stats["dispatches"],
           "mean_batch": float(np.mean(list(sizes.values())))
           if sizes else None,
           "first_dispatch_service_ms": service.get(min(service))
           if service else None,
           "other_dispatch_service_ms_p50": float(np.median(rest))
           if rest else None,
           "launches_per_dispatch": {
               name: launches[name] / n_disp for name in
               ("sinkhorn_fused_all_batched", "rwmd_min_cdist",
                "rwmd_min_cdist_subset")},
           "launches": launches}
    if "kcache" in stats:
        rec["kcache"] = stats["kcache"]
    return resps, stats, rec


def near_tie_ids(got, want, d, rtol: float, label: str) -> None:
    """Ids position by position, except in runs of distances within
    ``rtol`` of each other (P1), which are held as sets."""
    start = 0
    for j in range(1, len(d) + 1):
        if j == len(d) or d[j] - d[j - 1] > 2 * rtol * abs(d[j]):
            if set(got[start:j]) != set(want[start:j]):
                raise AssertionError(f"{label}: ids {list(got)} != "
                                     f"{list(want)}")
            start = j


def hold_served(resps, reqs, engine, label: str, ids=None, want=None,
                all_exact: bool = True) -> int:
    """Responses served at the exact tier equal ``engine.search`` of their
    own dispatch's batch replayed on the main thread (the same call: ids
    equal, distances at E2E_RTOL); with ``all_exact`` every response must
    be one. With ``want`` (the exhaustive top-k of all the queries at
    once, ``search(prune=None)``: no bound, so a cascade that drops a
    true neighbour fails here), each is also held against its query's
    row: another batch makes other chunk shapes, for which cuBLAS sums
    the K block in another order, so at exact word matches the distances
    move by P1 (ROADMAP queue 3): held at P1_RTOL, near ties as sets.
    Returns the responses checked."""
    batches = {}
    for r in resps:
        if r.ok and r.exact and r.tier == "exact":
            batches.setdefault(r.dispatch_id, []).append(r.rid)
        elif all_exact:
            raise AssertionError(f"serve {label}: rid {r.rid} not exact: "
                                 f"{r.tier} {r.error}")
    by_rid = {r.rid: r for r in resps}
    for did, rids in batches.items():
        rids = sorted(rids)                  # the dispatch's own order
        if len(rids) != by_rid[rids[0]].batch_size:
            raise AssertionError(f"serve {label}: dispatch {did} mixes "
                                 "tiers")
        res = engine.search([reqs[i] for i in rids], TOP_K,
                            prune=SERVE_PRUNE)
        for j, rid in enumerate(rids):
            r = by_rid[rid]
            if r.indices != res.indices[j].tolist():
                raise AssertionError(f"serve {label} rid {rid}: ids "
                                     f"{r.indices} != replayed "
                                     f"{res.indices[j].tolist()}")
            np.testing.assert_allclose(
                r.distances, res.distances[j], rtol=E2E_RTOL, atol=0,
                err_msg=f"serve {label} rid {rid} (replayed)")
    checked = [rid for rids in batches.values() for rid in rids]
    if want is not None:
        for rid in checked:
            r, d = by_rid[rid], want.distances[ids[rid]]
            np.testing.assert_allclose(r.distances, d, rtol=P1_RTOL, atol=0,
                                       err_msg=f"serve {label} rid {rid}")
            near_tie_ids(r.indices, want.indices[ids[rid]].tolist(), d,
                         P1_RTOL, f"serve {label} rid {rid}")
    return len(checked)


def launched(rec, names, label: str) -> None:
    for name in names:
        if rec["launches"][name] <= 0:
            raise AssertionError(f"serve {label}: {name} was not launched "
                                 f"({rec['launches']})")


def hold_admissible(resps, ids, exact, engine, label: str) -> int:
    """Every rwmd-tier distance (an RWMD bound) at most the query's
    exhaustive distance to the same doc, within the engine's own prune
    margin (``prune_slack``: the margin search trusts the bound with; on
    the card K2 and the cuBLAS K block differ by up to 2e-2 at exact word
    matches, ROADMAP queue 3, P1). Returns the responses checked."""
    n = 0
    for r, qi in zip(resps, ids):
        if not (r.ok and r.tier == "rwmd"):
            continue
        ex = exact[qi, r.indices]
        slack = engine.prune_slack * (np.abs(ex) + 1.0)
        if not (np.asarray(r.distances) <= ex + slack).all():
            raise AssertionError(f"serve {label} rid {r.rid}: rwmd bound "
                                 f"{r.distances} above {ex.tolist()}")
        n += 1
    return n


def phase_serve(corpus, index, card: str) -> dict:
    """The serving runtime over the kernel engine (log, lam=10) at the
    paper's widths: capacities C and C1, a warm-up through the runtime at
    every tier (one runtime per tier: launches per dispatch), then
    requests at 0.25 C1 (light load: every response exact, equal to the
    replay of its batch and to the exhaustive top-10) and at 2 C (every
    future resolves, no failed dispatch, exact responses equal their
    replay and the exhaustive top-10, load degrades or is rejected,
    rwmd-tier bounds admissible)."""
    engine = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                       precision="log")
    reqs, ids = serve_requests(corpus, SERVE_REQUESTS)
    c = serve_capacity(engine, reqs, "kernel_log", card)["capacity_per_s"]
    c1 = serve_capacity(engine, reqs, "kernel_log", card,
                        batch=1)["capacity_per_s"]
    qs = list(corpus.queries)
    exhaustive = engine.search(qs, TOP_K, prune=None)
    exact = engine.query_batch(qs).numpy()
    cfg = ServeConfig(max_batch=SERVE_BATCH)
    rec = {"phase": "serve", "card": card, "capacity_per_s": c,
           "capacity_1_per_s": c1,
           "config": {"max_batch": cfg.max_batch, "window_s": cfg.window_s,
                      "max_queue": cfg.max_queue,
                      "deadline_s": cfg.deadline_s, "prune": cfg.prune},
           "tiers": {}, "runs": {}}
    for tier in default_tiers(engine, SERVE_PRUNE):
        n = SERVE_WARM
        resps, _, run = serve_run(
            engine, reqs[:n], SERVE_LOW * c1,
            ServeConfig(max_batch=SERVE_BATCH, deadline_s=None),
            f"tier {tier.name}", tiers=(tier,))
        if not all(r.ok and r.tier == tier.name for r in resps):
            raise AssertionError(f"serve tier {tier.name}: not all served "
                                 "at that tier")
        if tier.solve:
            launched(run, ("sinkhorn_fused_all_batched",
                           "rwmd_min_cdist_subset"), tier.name)
        else:
            launched(run, ("rwmd_min_cdist",), tier.name)
            run["admissible_checked"] = hold_admissible(
                resps, ids[:n], exact, engine, tier.name)
        rec["tiers"][tier.name] = run
    for key, n, rate in (("0.25C1", SERVE_LIGHT, SERVE_LOW * c1),
                         ("2C", SERVE_REQUESTS, SERVE_HIGH * c)):
        resps, stats, run = serve_run(engine, reqs[:n], rate, cfg, key)
        run["exact_checked"] = hold_served(resps, reqs, engine, key, ids,
                                           exhaustive,
                                           all_exact=key == "0.25C1")
        launched(run, ("sinkhorn_fused_all_batched",), key)
        if stats["tiers"]["exact"]:
            launched(run, ("rwmd_min_cdist_subset",), key)
        if stats["tiers"].get("rwmd"):
            launched(run, ("rwmd_min_cdist",), key)
        run["admissible_checked"] = hold_admissible(resps, ids, exact,
                                                    engine, key)
        if key == "2C" and not (stats["degraded_frac"] > 0
                                or stats["rejected"] > 0):
            raise AssertionError(f"serve {key}: no degradation and no "
                                 f"rejection ({stats['tiers']})")
        rec["runs"][key] = run
    emit(rec)
    return rec


def phase_serve_faults(corpus, index, c1: float, card: str) -> dict:
    """Light load (0.25 C1) under injected transients, latency and poison:
    exactly the rids the injector poisons fail as ``poison``, every other
    response is answered, the guard retried. Then an fp32 lam=10 engine
    (its K underflows on this corpus): every response is
    ``lam_underflow`` with diagnostics, the card's own LamUnderflowError
    through the guard."""
    engine = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                       precision="log")
    reqs, _ = serve_requests(corpus, SERVE_LIGHT)
    poisoned = {rid for rid in range(len(reqs))
                if FaultInjector(**SERVE_FAULTS).poison(rid)}
    resps, stats, run = serve_run(
        engine, reqs, SERVE_LOW * c1, ServeConfig(max_batch=SERVE_BATCH),
        "faults", injector=FaultInjector(**SERVE_FAULTS), failed=())
    for r in resps:
        if r.rid in poisoned:
            if r.ok or r.error["code"] != "poison":
                raise AssertionError(f"serve_faults: rid {r.rid} was "
                                     f"poisoned but got {r.error}")
        elif not r.ok:
            raise AssertionError(f"serve_faults: rid {r.rid} failed: "
                                 f"{r.error}")
    if stats["retries"] <= 0:
        raise AssertionError("serve_faults: the guard never retried")
    hot = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter)
    uresps, ustats, urun = serve_run(
        hot, reqs[:8], SERVE_LOW * c1, ServeConfig(max_batch=SERVE_BATCH),
        "underflow", failed=())
    for r in uresps:
        if r.ok or r.error["code"] != "lam_underflow" \
                or not r.error.get("diagnostics"):
            raise AssertionError(f"serve_faults: fp32 lam={CONFIG.lam} "
                                 f"rid {r.rid} gave {r.error}")
    rec = {"phase": "serve_faults", "card": card, "capacity_1_per_s": c1,
           "injector": SERVE_FAULTS, "poisoned": sorted(poisoned),
           "run": run, "watchdog_trips": stats["watchdog_trips"],
           "isolations": stats["isolations"],
           "underflow": {**urun, "isolations": ustats["isolations"],
                         "precision": "fp32", "lam": CONFIG.lam}}
    emit(rec)
    return rec


def phase_serve_kcache(index, card: str) -> dict:
    """The einsum engine (log, lam=10) under the runtime's default
    K-column cache, on fig15's whole Zipf stream at 0.25 of its own C1.
    Every response is exact and equals the cache-off engine's search of
    its own dispatch's batch, replayed on the main thread: the cache-off
    run of the same batches (ids equal, distances at E2E_RTOL)."""
    stream = zipf_queries(128, index.vocab_size, words=32, s=1.0, seed=11)
    kw = dict(lam=CONFIG.lam, n_iter=CONFIG.n_iter, impl="sparse",
              precision="log")
    off = WmdEngine(index, **kw)
    c1 = serve_capacity(off, stream, "sparse_log", card,
                        batch=1)["capacity_per_s"]
    on = WmdEngine(index, **kw)
    resps, stats, run = serve_run(on, stream, SERVE_LOW * c1,
                                  ServeConfig(max_batch=SERVE_BATCH),
                                  "kcache on")
    if stats.get("kcache") is None:
        raise AssertionError("serve_kcache: the runtime did not enable the "
                             "cache on the einsum engine")
    torch.cuda.synchronize()
    ops.reset_launches()
    checked = hold_served(resps, stream, off, "kcache on")
    torch.cuda.synchronize()
    off_launches = ops.launches()
    for label, launches in (("on", run["launches"]), ("off", off_launches)):
        if launches["rwmd_min_cdist_subset"] <= 0:
            raise AssertionError(f"serve kcache {label}: "
                                 "rwmd_min_cdist_subset was not launched "
                                 f"({launches})")
    rec = {"phase": "serve_kcache", "card": card, "capacity_1_per_s": c1,
           "stream": {"queries": len(stream), "words": 32, "zipf_s": 1.0,
                      "seed": 11}, "slots": ServeConfig.kcache_slots,
           "hit_rate": stats["kcache"]["hit_rate"], "on": run,
           "off_replayed": {"responses": checked,
                            "launches": off_launches},
           "ids_equal": True}
    emit(rec)
    return rec


def phase_profile_serve(corpus, index, c: float, card: str) -> dict:
    """Where a served request's time goes under load: torch.profiler over
    one open-loop run of 64 requests at 0.25 C (a fresh runtime; a warm
    run before the window): the card's idle share over the window, device
    time per request, and the host time of the rank stage (the stable
    argsort and gathers at the end of search, timed on each request's
    exhaustive distances cut to its query's solved count)."""
    engine = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                       precision="log")
    reqs, ids = serve_requests(corpus, SERVE_PROFILED, seed=2)
    out = {}

    def run():
        out["run"] = serve_run(engine, reqs, SERVE_LOW * c,
                               ServeConfig(max_batch=SERVE_BATCH),
                               "profile")

    wall_us, dev_ev, host, busy_us = profile_window(run, 1)
    resps, _, run_rec = out["run"]
    launched(run_rec, ("sinkhorn_fused_all_batched",), "profile")
    qs = list(corpus.queries)
    solved = engine.search(qs, TOP_K, prune=SERVE_PRUNE).solved
    exact = engine.query_batch(qs).numpy()
    t0 = time.perf_counter()
    for qi in ids:
        d = exact[qi, :solved[qi]]
        order = np.argsort(d, kind="stable")[:TOP_K]
        _ = (order.astype(np.int32), d[order])
    rank_ms = (time.perf_counter() - t0) * 1e3 / len(ids)
    rec = profile_record("profile_serve", wall_us, dev_ev, host, busy_us, 1,
                         card=card, requests=len(reqs),
                         rate_per_s=SERVE_LOW * c)
    if dev_ev:
        rec["device_idle_share"] = 1.0 - busy_us / wall_us
        rec["device_ms_per_request"] = busy_us / 1e3 / len(reqs)
    rec["rank_host_ms_per_request"] = rank_ms
    rec["solved_per_query"] = solved.tolist()
    rec["run"] = run_rec
    emit(rec)
    return rec


def phase_wmd_defaults(dev) -> dict:
    """``many_to_many`` and ``wmd.search`` with every default argument
    (impl "sparse", lam=10, n_iter=15, prune "rwmd", k=10) on the card,
    on a corpus whose distances keep lam=10 above the fp32 exp horizon:
    finite, and search's top-10 is each query's exhaustive top-10."""
    from repro_torch.core import search as wmd_search
    c = make_corpus(vocab_size=4096, embed_dim=8, n_docs=512, n_queries=6,
                    seed=5)
    qs = list(c.queries)
    full = torch.stack(many_to_many(qs, c.docs, c.vecs)).cpu().numpy()
    res = wmd_search(qs, c.docs, c.vecs)
    if not np.isfinite(full).all():
        raise AssertionError("many_to_many defaults: non-finite distances")
    ex_i = np.argsort(full, axis=1, kind="stable")[:, :10]
    if not np.array_equal(res.indices, ex_i):
        raise AssertionError("wmd.search defaults: top-10 differs from the "
                             "exhaustive top-10")
    rec = {"phase": "wmd_defaults", "queries": len(qs), "n_docs": 512,
           "shape": list(full.shape), "top10_equal": True}
    emit(rec)
    return rec


# ------------------------------------------------------------ the shards
def full_coverage(engine, label: str) -> None:
    """No fallback: outside the runs that inject faults, a sharded search
    that left a shard out (a failed launch turns into a partial result in
    the fan-out's error handling) fails the phase."""
    cov = engine.last_coverage
    if not cov.full:
        raise AssertionError(f"{label}: partial coverage {cov}")


def hold_sharded(res, base, label: str, bitwise: bool) -> None:
    """A sharded result against the single engine's: bit for bit (ids,
    distances and solved) or, with more shards, distances at P1_RTOL and
    ids under the near-tie rule: each shard stages its own chunks, and
    cuBLAS sums another chunk's K block in another order (P1)."""
    if bitwise:
        if not (np.array_equal(res.indices, base.indices)
                and np.array_equal(res.distances, base.distances)
                and np.array_equal(res.solved, base.solved)):
            raise AssertionError(f"{label}: not bit for bit the single "
                                 "engine's result")
        return
    np.testing.assert_allclose(res.distances, base.distances, rtol=P1_RTOL,
                               atol=0, err_msg=label)
    for qi in range(base.indices.shape[0]):
        near_tie_ids(res.indices[qi].tolist(), base.indices[qi].tolist(),
                     base.distances[qi], P1_RTOL, f"{label} query {qi}")


def hold_exhaustive(res, ex, label: str) -> None:
    """A pruned search of the single engine against its exhaustive top-k
    (``prune=None``: no bound, so a stage that drops a true neighbour, or
    a K2s that over-prunes, fails here): distances at E2E_RTOL, ids under
    the near-tie rule."""
    np.testing.assert_allclose(res.distances, ex.distances, rtol=E2E_RTOL,
                               atol=0, err_msg=label)
    for qi in range(ex.indices.shape[0]):
        near_tie_ids(res.indices[qi].tolist(), ex.indices[qi].tolist(),
                     ex.distances[qi], E2E_RTOL, f"{label} query {qi}")


def shard_launches(engine, qs, prune: str) -> dict:
    """K1, K2 and K2s launches of one search of each shard run alone, and
    of one sharded search (whose fan-out runs them concurrently), which
    must be their sum; and the collectives of that search."""
    names = ("sinkhorn_fused_all_batched", "rwmd_min_cdist",
             "rwmd_min_cdist_subset")
    per_shard = []
    for e in engine.engines:
        torch.cuda.synchronize()
        ops.reset_launches()
        e.search(qs, TOP_K, prune=prune)
        torch.cuda.synchronize()
        per_shard.append({n: ops.launches()[n] for n in names})
    ops.reset_launches()
    colls = count_collectives(engine.search, qs, TOP_K, prune=prune)
    torch.cuda.synchronize()
    full_coverage(engine, f"shards launches {prune}")
    total = {n: ops.launches()[n] for n in names}
    summed = {n: sum(p[n] for p in per_shard) for n in names}
    if total != summed:
        raise AssertionError(f"shards {prune}: launches {total} are not "
                             f"the shards' sum {summed}")
    if colls != {"all_gather": 1}:
        raise AssertionError(f"shards {prune}: the merge ran {colls}, not "
                             "one all_gather")
    return {"per_shard": per_shard, "summed": total, "collectives": colls}


def phase_shards(corpus, index, card: str) -> dict:
    """``ShardedWmdEngine`` over S in SHARD_COUNTS shards of the paper
    corpus on ``corpus_mesh(S)`` (log, lam=10, k=10, the 10 paper
    queries): for each S and prune spec the result against the single
    engine's (one shard bit for bit), the launches per shard and summed,
    the merge's one all_gather, and 15 warm searches beside the single
    engine's 15, both untraced, with the merge's share from 15 more under
    the recorder (``wmd.shard.merge``); then the card's idle share over
    one profiled 2-shard cascade search. The single engine's results are
    first held against its exhaustive top-10, and K2s against its plain
    version at the inputs of the widest RWMD stage of the single engine's
    and of every shard's cascade search of these queries."""
    qs = list(corpus.queries)
    kw = dict(lam=CONFIG.lam, n_iter=CONFIG.n_iter, precision="log")
    single = WmdEngine(index, **kw)
    rec = {"phase": "shards", "card": card, "queries": len(qs), "k": TOP_K,
           "precision": "log", "lam": CONFIG.lam, "nprobe": None,
           "prunes": list(SHARD_PRUNES), "single": {}, "shards": {}}
    exhaustive = single.search(qs, TOP_K, prune=None)
    base = {}
    for prune in SHARD_PRUNES:
        base[prune] = single.search(qs, TOP_K, prune=prune)
        hold_exhaustive(base[prune], exhaustive, f"shards single {prune}")
        rec["single"][prune] = {"search_ms": wall_ms(
            lambda: single.search(qs, TOP_K, prune=prune))}
    k2s = {"single": phase_k2s_from_search(index, [qs], "shards_single")}
    engines = {}
    for n in SHARD_COUNTS:
        t0 = time.perf_counter()
        mesh = corpus_mesh(n)
        sindex = shard_corpus(corpus.docs, corpus.vecs, n, devices=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng = ShardedWmdEngine(sindex, **kw)
        engines[n] = eng
        srec = {"placement": [str(d) for d in mesh.devices],
                "docs_per_shard": list(sindex.docs_per_shard),
                "clusters_per_shard": list(sindex.cluster_counts),
                "build_s": build_s, "prunes": {}}
        for prune in SHARD_PRUNES:
            label = f"shards S={n} {prune}"
            res = eng.search(qs, TOP_K, prune=prune)
            full_coverage(eng, label)
            hold_sharded(res, base[prune], label, bitwise=n == 1)
            launches = shard_launches(eng, qs, prune)

            def timed():
                eng.search(qs, TOP_K, prune=prune)
                full_coverage(eng, label)

            eng.reset_iter_stats()
            t = wall_ms(timed)              # untraced, as the single's
            trace.enable()
            for _ in range(E2E_REPS):
                timed()
            trace.disable()
            merge_ns = sum(s.end_ns - s.start_ns
                           for s in trace.records().spans
                           if s.name == "wmd.shard.merge")
            srec["prunes"][prune] = {
                "search_ms": t, "launches": launches,
                "merge_ms_per_search": merge_ns / 1e6 / E2E_REPS,
                "ratio_to_single": t["median"]
                / rec["single"][prune]["search_ms"]["median"],
                "solved": res.solved.tolist(),
                "held": "bitwise" if n == 1 else "near_tie_P1"}
        for si, ix in enumerate(sindex.shards):
            k2s[f"S={n} shard {si}"] = phase_k2s_from_search(
                ix, [qs], f"shards_S{n}_shard{si}")
        rec["shards"][str(n)] = srec
    rec["k2s_checked"] = {key: {"shape": r["shape"],
                                "subset_route": r["subset_route"],
                                "max_abs_err": r["max_abs_err"],
                                "ms": r["ms"]} for key, r in k2s.items()}
    two = engines[2]
    out = profile_window(lambda: two.search(qs, TOP_K,
                                            prune=SHARD_PRUNES[0]), 1)
    full_coverage(two, "shards profile")
    prof = profile_record("profile_shards", *out, 1, shards=2,
                          prune=SHARD_PRUNES[0])
    if out[1]:
        prof["device_idle_share"] = 1.0 - out[3] / out[0]
    rec["profile_2_shards"] = prof
    emit(rec)
    return {"record": rec, "engines": engines, "base": base, "k2s": k2s}


def phase_shard_snapshot(corpus, engine, card: str) -> dict:
    """Snapshots and recovery on a 2-shard engine of the paper corpus:
    ``snapshot()``; a raw exception on shard 1 gives a partial result from
    shard 0 only, with honest ``last_coverage``; a hang longer than the
    fan-out's deadline gives ``"timeout"``; ``restore_shard(1)`` brings
    back full coverage bit for bit the baseline; a snapshot taken before
    ``append_docs_sharded`` is refused as stale."""
    import shutil
    import threading
    qs = list(corpus.queries)
    prune = SHARD_PRUNES[0]
    shutil.rmtree(SHARD_SNAPSHOT_DIR, ignore_errors=True)
    engine.shard_retries = 0
    baseline = engine.search(qs, TOP_K, prune=prune)
    full_coverage(engine, "shard_snapshot baseline")
    t0 = time.perf_counter()
    paths = engine.snapshot(str(SHARD_SNAPSHOT_DIR))
    snap_s = time.perf_counter() - t0
    rec = {"phase": "shard_snapshot", "card": card, "shards": 2,
           "docs_per_shard": list(engine.docs_per_shard),
           "snapshot_s": snap_s, "snapshot_bytes": sum(
               Path(p).stat().st_size for p in paths)}
    orig = engine.engines[1].search

    def boom(*a, **kw):
        raise ValueError("injected shard death")

    engine.engines[1].search = boom
    res = engine.search(qs, TOP_K, prune=prune)
    cov = engine.last_coverage
    frac0 = engine.docs_per_shard[0] / engine.n_docs
    if cov.missing_shards != (1,) or abs(cov.fraction - frac0) > 1e-9 \
            or "ValueError" not in cov.reasons.get(1, ""):
        raise AssertionError(f"shard_snapshot raw exception: {cov}")
    shard0 = set(engine.sindex.global_ids[0].tolist())
    if not set(res.indices[res.indices >= 0].tolist()) <= shard0:
        raise AssertionError("shard_snapshot: the partial result holds ids "
                             "of the dead shard")
    rec["raw_exception"] = {"coverage": cov.fraction,
                            "missing": list(cov.missing_shards),
                            "reason": cov.reasons[1]}
    release, finished = threading.Event(), threading.Event()

    def hang(*a, **kw):
        try:
            release.wait(60.0)
            return orig(*a, **kw)
        finally:
            finished.set()

    engine.engines[1].search = hang
    engine.shard_timeout_s = SHARD_TIMEOUT_S
    t0 = time.perf_counter()
    engine.search(qs, TOP_K, prune=prune)
    hang_s = time.perf_counter() - t0
    reason = engine.last_coverage.reasons.get(1)
    release.set()
    finished.wait(120.0)                # the hung shard's thread is done
    engine.shard_timeout_s = 30.0
    if reason != "timeout":
        raise AssertionError(f"shard_snapshot hang: {engine.last_coverage}")
    rec["hang"] = {"timeout_s": SHARD_TIMEOUT_S, "search_s": hang_s,
                   "reason": reason}
    t0 = time.perf_counter()
    engine.restore_shard(1)             # the rebuilt engine drops the patch
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    res = engine.search(qs, TOP_K, prune=prune)
    full_coverage(engine, "shard_snapshot restored")
    if not (np.array_equal(res.indices, baseline.indices)
            and np.array_equal(res.distances, baseline.distances)):
        raise AssertionError("shard_snapshot: the restored search is not "
                             "bit for bit the baseline")
    rec["restored_bitwise"] = True
    grown = append_docs_sharded(engine.sindex, PaddedDocs(
        idx=corpus.docs.idx[:16], val=corpus.docs.val[:16]))
    stale = []
    for si in range(grown.n_shards):
        if grown.docs_per_shard[si] == engine.docs_per_shard[si]:
            continue
        try:
            restore_shard(grown, si, str(SHARD_SNAPSHOT_DIR))
        except ValueError as e:
            if "STALE" not in str(e):
                raise
            stale.append(si)
        else:
            raise AssertionError(f"shard_snapshot: a stale snapshot of "
                                 f"shard {si} was restored")
    if not stale:
        raise AssertionError("shard_snapshot: the append grew no shard")
    rec["stale_refused"] = stale
    engine.shard_retries = 1
    emit(rec)
    return rec


def phase_serve_shards(corpus, index, engine, card: str) -> dict:
    """The serving runtime over a 2-shard engine (log, lam=10): its own C1,
    64 requests at 0.25 C1 (every response exact with full coverage,
    equal to the replay of its batch and to the exhaustive top-10, K1 and
    K2s launched), then SHARD_SERVE_FAULT requests with shard 1 crashed
    (every response answered, tagged partial, never exact), then after
    ``restore_shard(1)`` and ``revive_shard()`` as many again, clean."""
    reqs, ids = serve_requests(corpus, SERVE_LIGHT)
    c1 = serve_capacity(engine, reqs, "sharded_2_log", card,
                        batch=1)["capacity_per_s"]
    full_coverage(engine, "serve_shards capacity")
    qs = list(corpus.queries)
    exhaustive = WmdEngine(index, lam=CONFIG.lam, n_iter=CONFIG.n_iter,
                           precision="log").search(qs, TOP_K, prune=None)
    cfg = ServeConfig(max_batch=SERVE_BATCH)
    engine.snapshot(str(SHARD_SNAPSHOT_DIR))
    rec = {"phase": "serve_shards", "card": card, "shards": 2,
           "capacity_1_per_s": c1, "runs": {}}
    resps, stats, run = serve_run(engine, reqs, SERVE_LOW * c1, cfg,
                                  "shards 0.25C1")
    if stats["partial"] or any(r.partial for r in resps):
        raise AssertionError(f"serve_shards: partial responses without "
                             f"faults ({stats['partial']})")
    run["exact_checked"] = hold_served(resps, reqs, engine, "shards 0.25C1",
                                       ids, exhaustive)
    launched(run, ("sinkhorn_fused_all_batched", "rwmd_min_cdist_subset"),
             "shards 0.25C1")
    rec["runs"]["0.25C1"] = run
    injector = FaultInjector(crash_shard=1, crash_after=0, seed=1)
    n = SHARD_SERVE_FAULT
    resps, stats, run = serve_run(engine, reqs[:n], SERVE_LOW * c1, cfg,
                                  "shards crash", injector=injector)
    for r in resps:
        if not (r.ok and r.partial and not r.exact
                and r.missing_shards == [1]):
            raise AssertionError(f"serve_shards crash: rid {r.rid} "
                                 f"ok={r.ok} partial={r.partial} "
                                 f"exact={r.exact} {r.error}")
    run["partial"] = stats["partial"]
    run["coverage"] = resps[0].coverage
    rec["runs"]["crash_shard_1"] = run
    injector.revive_shard()
    engine.restore_shard(1)
    resps, stats, run = serve_run(engine, reqs[:n], SERVE_LOW * c1, cfg,
                                  "shards recovered", injector=injector)
    if stats["partial"] or any(r.partial for r in resps):
        raise AssertionError("serve_shards: partial responses after the "
                             "shard was restored")
    run["exact_checked"] = hold_served(resps, reqs, engine,
                                       "shards recovered", ids, exhaustive)
    rec["runs"]["recovered"] = run
    emit(rec)
    return rec


def phase_distributed(corpus, card: str) -> dict:
    """The distributed solvers over a (2, 4) ("data", "model") mesh of
    positions on ``make_mesh`` (round-robin over the visible cards) at the
    widest paper query, lam=1: the sparse solver, fixed and adaptive, with
    vshard on and off, at all 5000 documents against
    ``one_to_many(impl="sparse")`` at DIST_ATOL (the adaptive loop at the
    count the single-device ``sinkhorn_wmd_sparse`` realizes under the same
    ``tol``, which it must realize too), with its collectives counted (fixed: none but vshard's
    one psum_scatter; adaptive: pmax); the dense solver with N cut to
    DIST_DENSE_DOCS against the single-device dense one; and a poisoning
    lam that must raise LamUnderflowError naming the owning shard."""
    from repro_torch.core.sinkhorn import sinkhorn_wmd_dense
    from repro_torch.core.sinkhorn_sparse import sinkhorn_wmd_sparse
    mesh = make_mesh(*DIST_MESH)
    dev = mesh.devices[0]
    q = widest_query(corpus)
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    r, sel, _ = select_support(q, vecs)
    inp = sharded_inputs(mesh, r, sel, vecs, corpus.docs)
    lam, n_iter = 1.0, CONFIG.n_iter
    rec = {"phase": "distributed", "card": card,
           "mesh": mesh.describe(),
           "lam": lam, "n_iter": n_iter, "v_r": int(r.shape[0]),
           "n_docs": int(corpus.docs.idx.shape[0]), "atol": DIST_ATOL,
           "sparse": {}}
    ref = one_to_many(q, inp["docs"], vecs, lam, n_iter, impl="sparse",
                      device=dev)
    ad = dict(tol=PQ["tol"], check_every=PQ["check_every"])
    _, ref_iters = sinkhorn_wmd_sparse(r, sel, vecs, inp["docs"], lam,
                                       PQ["n_iter"], return_iters=True, **ad)
    ref_ad = one_to_many(q, inp["docs"], vecs, lam, int(ref_iters),
                         impl="sparse", device=dev)
    for adaptive in (False, True):
        for vshard in (False, True):
            key = f"{'adaptive' if adaptive else 'fixed'}_vshard_{vshard}"
            extra = dict(ad, n_iter=PQ["n_iter"]) if adaptive \
                else dict(n_iter=n_iter)
            out = {}

            def run():
                out["d"], out["iters"] = sinkhorn_wmd_sparse_distributed(
                    inp["r"], inp["vecs_sel"], inp["vecs"], inp["docs"],
                    lam, mesh=mesh, vshard_precompute=vshard,
                    return_iters=True, **extra)

            colls = count_collectives(run)
            want = ref_ad if adaptive else ref
            err = float((out["d"] - want).abs().max())
            if not err < DIST_ATOL:
                raise AssertionError(f"distributed {key}: max abs err {err}")
            if adaptive and out["iters"].tolist() != [int(ref_iters)]:
                raise AssertionError(f"distributed {key}: {out['iters']} "
                                     f"iterations, not {ref_iters}")
            expect = {"psum_scatter"} if vshard else set()
            if adaptive:
                expect |= {"pmax"}
            if set(colls) != expect or colls.get("psum_scatter", 1) != 1:
                raise AssertionError(f"distributed {key}: collectives "
                                     f"{colls}")
            rec["sparse"][key] = {
                "max_abs_err": err, "collectives": colls,
                "iters": out["iters"].tolist(),
                "ms": wall_ms(run, reps=3)["median"]}
    rec["sparse_reference_iters"] = int(ref_iters)
    nd = DIST_DENSE_DOCS
    c = torch.as_tensor(padded_docs_to_dense(PaddedDocs(
        idx=corpus.docs.idx[:nd], val=corpus.docs.val[:nd]),
        vecs.shape[0]), device=dev)
    want = sinkhorn_wmd_dense(r, sel, vecs, c, lam, n_iter)
    out = {}

    def dense():
        out["d"] = sinkhorn_wmd_dense_distributed(r, sel, vecs, c, lam,
                                                  n_iter, mesh)

    colls = count_collectives(dense)
    err = float((out["d"] - want).abs().max())
    if not err < DIST_ATOL or set(colls) != {"psum"}:
        raise AssertionError(f"distributed dense: err {err}, {colls}")
    rec["dense"] = {"n_docs": nd, "cut": f"N cut to {nd} of 5000: the "
                    "(V, N) temporaries at 5000 are ~2 GB an iteration",
                    "max_abs_err": err, "collectives": colls,
                    "ms": wall_ms(dense, reps=3)["median"]}
    try:
        sinkhorn_wmd_sparse_distributed(
            inp["r"], inp["vecs_sel"], inp["vecs"], inp["docs"],
            DIST_POISON_LAM, n_iter, mesh,
            doc_ids=np.arange(corpus.docs.idx.shape[0]) + 70000)
    except LamUnderflowError as e:
        if "owning shard" not in str(e) or "external doc ids" not in str(e):
            raise AssertionError(f"distributed underflow report: {e}")
        rec["underflow"] = {"lam": DIST_POISON_LAM,
                            "report": str(e)[:160]}
    else:
        raise AssertionError(f"distributed: lam={DIST_POISON_LAM} did not "
                             "raise LamUnderflowError")
    emit(rec)
    return rec


def lm_decode(model, batch: int, steps: int, cache=None):
    """``steps`` greedy serve steps from token 1: (tokens (B, steps),
    logits (B, steps, V), cache)."""
    step = make_serve_step(model)
    if cache is None:
        cache = model.init_cache(batch, steps)
    tok = torch.ones((batch, 1), dtype=torch.long,
                     device=model.embed.device)
    toks, logits = [], []
    for _ in range(steps):
        tok, lg, cache = step(cache, tok)
        toks.append(tok)
        logits.append(lg)
    return torch.cat(toks, 1), torch.stack(logits, 1), cache


def small_cfg(arch: str, router=None):
    """The reduced config of ``arch``, with ``router`` for the MoE."""
    import dataclasses
    cfg = get_config(arch).reduced()
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    return cfg


def phase_lm_small_parity(dev) -> None:
    """The reduced LMs on the card against the same weights on the host:
    equal tokens and logits within fp32 rounding, LM_SMALL_STEPS steps."""
    import copy
    rows = []
    for arch, router in LM_SMALL:
        cfg = small_cfg(arch, router)
        router = cfg.moe.router if cfg.moe else None
        host = Transformer(cfg, 0, device="cpu")
        card = copy.deepcopy(host).to(dev)
        with torch.inference_mode():
            th, lh, _ = lm_decode(host, LM_BATCH, LM_SMALL_STEPS)
            tc, lc, _ = lm_decode(card, LM_BATCH, LM_SMALL_STEPS)
            if not torch.equal(tc.cpu(), th):
                raise AssertionError(f"lm_small_parity {arch} {router}: "
                                     "card and host tokens differ")
            err = compare(lc.cpu(), lh, LM_RTOL, LM_ATOL,
                          f"lm_small_parity {arch} {router}")
            rows.append({"arch": arch, "router": router,
                         "max_abs_err": err[0]})
    emit({"phase": "lm_small_parity", "steps": LM_SMALL_STEPS,
          "batch": LM_BATCH, "rtol": LM_RTOL, "atol": LM_ATOL,
          "archs": rows})


def lm_step_bytes(model, batch: int, pos: float) -> float:
    """Bytes one decode step must move: every weight once (the capacity
    dispatch runs every expert on its buffer), but of an untied embedding
    only the ``batch`` rows it gathers and the hybrid's shared block once
    per application (each depends on the layers before it); the KV
    cache's live entries at position ``pos`` (read, and one written) of
    every attention layer or application; the ssm family's wkv state (read
    and written) and token shift (slot 0 read, both slots written); the
    hybrid's conv and SSM states (read and written)."""
    cfg = model.cfg
    d = cfg.d_model
    n = sum(p.numel() for p in model.parameters())
    if model.lm_head is not None:
        n -= model.embed.numel() - batch * d
    n_attn, state = cfg.num_layers, 0
    if cfg.family == "ssm":
        n_attn = 0
        tmix = model.layers[0].tmix
        state = cfg.num_layers * batch * (
            2 * tmix.wo.shape[1] * tmix.head_dim + 3 * d)
    elif cfg.family == "hybrid":
        s = cfg.ssm
        n_attn = model.n_groups
        n += (n_attn - 1) * sum(p.numel()
                                for p in model.shared_block.parameters())
        d_in = s.expand * d
        state = 2 * cfg.num_layers * batch * (
            (s.conv_width - 1) * (d_in + 2 * s.d_state) + d_in * s.d_state)
    kv = 2 * n_attn * batch * model.n_kv * cfg.head_dim * (pos + 2)
    return 4.0 * (n + kv + state)


def lm_step_flops(model, batch: int, pos: float) -> float:
    """fp32 operations of one decode step: the products at ``batch``
    tokens (the MoE's at E x cap rows of its buffers), attention over
    ``pos + 1`` positions, rwkv6's WKV update and readout (7 operations an
    element of each head's D x D state), Mamba2's conv, state update and
    readout (6 an element of its state), the hybrid's shared block at each
    application."""
    cfg = model.cfg
    d, hd = cfg.d_model, cfg.head_dim
    head = 2 * batch * d * model.lm_head_matrix().shape[0]
    attn = 2 * batch * d * (2 * model.n_q + 2 * model.n_kv) * hd \
        + 4 * batch * model.n_q * hd * (pos + 1)
    if cfg.moe:
        sp = cfg.moe
        cap = int(sp.capacity_factor * sp.top_k * batch / sp.n_experts + 1)
        ffn = 6 * sp.n_experts * cap * d * sp.d_ff \
            + 6 * batch * d * sp.n_shared * sp.d_ff \
            + 2 * batch * d * sp.n_experts
    else:
        ffn = (6 if cfg.mlp == "swiglu" else 4) * batch * d * cfg.d_ff
    s = cfg.ssm
    if cfg.family == "ssm":
        tmix = model.layers[0].tmix
        da = tmix.wo.shape[1]
        mix = 2 * batch * (5 * d * da + s.decay_lora * (d + da)) \
            + 7 * batch * da * tmix.head_dim
        return float(cfg.num_layers * (mix + ffn) + head)
    if cfg.family == "hybrid":
        d_in = s.expand * d
        # w_z, w_x, w_bc, w_dt and out_proj; the conv; the state
        mamba = 2 * batch * d * (3 * d_in + 2 * s.d_state
                                 + d_in // s.head_dim) \
            + 2 * batch * s.conv_width * (d_in + 2 * s.d_state) \
            + 6 * batch * d_in * s.d_state
        return float(cfg.num_layers * mamba + model.n_groups * (attn + ffn)
                     + head)
    return float(cfg.num_layers * (attn + ffn) + head)


def hold_prefill_decode(model, gen, length: int = LM_PREFILL_LEN) -> dict:
    """Logits of ``length`` positions from one prefill forward against
    token-by-token decode, for LM_PREFILL_BATCH random sequences."""
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (LM_PREFILL_BATCH, length),
                           generator=gen, device=gen.device)
    hidden, _ = model(tokens)
    full = torch.nn.functional.linear(
        hidden, model.lm_head_matrix()).float()[..., :cfg.vocab_size]
    cache = model.init_cache(LM_PREFILL_BATCH, length)
    dec = torch.stack([model.decode_step(cache, tokens[:, t:t + 1])[0]
                       for t in range(length)], 1)
    # make_prefill, the entry point, against decode's last position: the
    # (B, d) head GEMM and the (B, T, d) one above sum a d-long dot in
    # other orders, so it is held at the prefill tolerance, not bit-near
    last = make_prefill(model)(tokens)[:, :cfg.vocab_size]
    err = (dec - full).abs()
    err_last = (last - dec[:, -1]).abs()
    return {"batch": LM_PREFILL_BATCH, "len": length,
            "max_abs_err": float(err.max()),
            "prefill_entry_max_abs_err": float(err_last.max()),
            "within": bool(torch.allclose(dec, full, rtol=LM_PREFILL_TOL,
                                          atol=LM_PREFILL_TOL)
                           and torch.allclose(last, dec[:, -1],
                                              rtol=LM_PREFILL_TOL,
                                              atol=LM_PREFILL_TOL))}


def set_moe(model, **spec) -> dict:
    """Replace fields of every MoE layer's spec; returns the old specs by
    layer, for :func:`restore_moe`."""
    import dataclasses
    old = {}
    for i, blk in enumerate(model.layers):
        if blk.moe is not None:
            old[i] = blk.moe.spec
            blk.moe.spec = dataclasses.replace(blk.moe.spec, **spec)
    return old


def restore_moe(model, old: dict) -> None:
    for i, spec in old.items():
        model.layers[i].moe.spec = spec


def phase_lm_full(dev, arch: str, phase: str, card: str,
                  layers: int | None = None) -> dict:
    """``arch`` at full width in fp32 with random weights (seed 0, made on
    the card), at its published depth or cut to ``layers``: LM_STEPS serve
    steps at LM_BATCH, their p50/p99 and tokens per second, peak memory,
    the step's bound, a profiled window's busy share, and prefill against
    decode."""
    import dataclasses
    published = get_config(arch)
    cfg = published
    if layers is not None and layers != published.num_layers:
        cfg = dataclasses.replace(published, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"phase": phase, "arch": arch, "nvidia_smi": card,
           "dtype": "float32", "batch": LM_BATCH, "steps": LM_STEPS,
           "layers": cfg.num_layers,
           "published_layers": published.num_layers,
           "reduced": ([] if cfg is published else
                       [f"num_layers {published.num_layers} -> "
                        f"{cfg.num_layers}: the fp32 weights of the "
                        "published depth do not fit one card"]),
           "published_n_params_config": published.n_params()}
    with torch.inference_mode():
        t0 = time.perf_counter()
        gen = torch.Generator(dev).manual_seed(0)
        model = Transformer(cfg, gen, device=dev)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = sum(p.numel() for p in model.parameters())
        rec["param_bytes"] = 4 * rec["params"]
        rec["n_params_config"] = cfg.n_params()
        rec["n_active_params_config"] = cfg.n_active_params()
        max_len = LM_STEPS + LM_PROFILE_STEPS + 1
        cache = model.init_cache(LM_BATCH, max_len)
        step = make_serve_step(model)
        tok = torch.ones((LM_BATCH, 1), dtype=torch.long, device=dev)
        times = []
        for _ in range(LM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(cache, tok)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{phase}: non-finite logits")
        if logits.shape != (LM_BATCH, cfg.vocab_size):
            raise AssertionError(f"{phase}: logits {tuple(logits.shape)}")
        ms = np.asarray(times[2:])
        rec.update(ms_per_token_p50=float(np.percentile(ms, 50)),
                   ms_per_token_p99=float(np.percentile(ms, 99)),
                   ms_per_token_mean=float(ms.mean()),
                   tokens_per_s=LM_BATCH / (ms.mean() / 1e3),
                   first_steps_ms=times[:2], last_tokens=tok[:, 0].tolist())
        pos = (LM_STEPS - 1) / 2
        b, kind = bound_ms(lm_step_bytes(model, LM_BATCH, pos),
                           lm_step_flops(model, LM_BATCH, pos))
        rec.update(step_bytes=lm_step_bytes(model, LM_BATCH, pos),
                   step_flops=lm_step_flops(model, LM_BATCH, pos),
                   bound_ms=b, bound_by=kind,
                   bound_share=b / rec["ms_per_token_p50"])
        state = {"cache": cache, "tok": tok}

        def one_step():
            state["tok"], _, state["cache"] = step(state["cache"],
                                                   state["tok"])
        prof = profile_record(f"{phase}_profile",
                              *profile_window(one_step, LM_PROFILE_STEPS),
                              LM_PROFILE_STEPS)
        rec["profile"] = prof
        rec["device_busy_share"] = prof.get("device_busy_share")
        if cfg.moe:
            # the MoE inputs of every layer at one decode step of the batch
            inputs = []
            hooks = [blk.moe.register_forward_pre_hook(
                lambda _m, args: inputs.append(args[0]))
                for blk in model.layers]
            c1 = model.init_cache(LM_BATCH, 2)
            model.decode_step(c1, tok)
            for h in hooks:
                h.remove()
            rec["moe_dropped_fraction"] = {
                kind: float(np.mean([float(moe_dropped_fraction(
                    blk.moe, x, kind)) for blk, x in zip(model.layers,
                                                          inputs)]))
                for kind in ("sinkhorn", "topk")}
            # the config's router balances over the tokens routed together
            # and its capacity depends on their count, so prefill and
            # decode route differently (ROADMAP R9): measured, not held
            rec["prefill_vs_decode_config_router"] = hold_prefill_decode(
                model, gen)
            # held: per-token routing with a slot for every token, where
            # the two passes compute one function
            old = set_moe(model, router="topk", capacity_factor=(
                cfg.moe.n_experts / cfg.moe.top_k))
            held = hold_prefill_decode(model, gen)
            restore_moe(model, old)
            held["moe"] = "topk, capacity_factor n_experts/top_k"
        else:
            held = hold_prefill_decode(model, gen, LM_SSM_PREFILL_LEN
                                       if cfg.ssm else LM_PREFILL_LEN)
        rec["prefill_vs_decode"] = held
        if not held["within"]:
            raise AssertionError(
                f"{phase}: prefill and decode logits differ by "
                f"{held['max_abs_err']}, make_prefill's by "
                f"{held['prefill_entry_max_abs_err']}")
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del model, cache, state
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def phase_lm_ep_hold(dev) -> dict:
    """The reduced qwen2_moe (its config's router) with its weights on the
    host and its LM_EP_MESH positions on the card: LM_SMALL_STEPS serve
    steps with grad off, where the first copies each MoE layer's slices
    to the card once (the routed experts' and the shared expert's per
    model index, and the router) and every later step none; then the same
    input tokens in grad mode, which copies them on every call. The two
    paths' logits must be equal bit for bit."""
    cfg = small_cfg("qwen2_moe_a2_7b")
    model = Transformer(cfg, 0, device="cpu")
    mesh = make_mesh(*LM_EP_MESH, devices=[dev])
    tp = mesh.axis_size("model")
    n_moe = sum(blk.moe is not None for blk in model.layers)
    per_layer = tp * (3 + 3 * (cfg.moe.n_shared > 0)) + 1
    step = make_serve_step(model, mesh)

    def run(inputs, mode):
        """LM_SMALL_STEPS steps under ``mode``, greedy from token 1 or
        fed ``inputs``: (the tokens fed, logits, slice copies a step)."""
        cache = model.init_cache(LM_BATCH, LM_SMALL_STEPS)
        tok = torch.ones((LM_BATCH, 1), dtype=torch.long)
        fed, logits, copies = [], [], []
        for t in range(LM_SMALL_STEPS):
            if inputs is not None:
                tok = inputs[:, t:t + 1]
            fed.append(tok)
            c0 = slice_copies()
            with mode():
                tok, lg, cache = step(cache, tok)
            copies.append(slice_copies() - c0)
            logits.append(lg.detach())
        return torch.cat(fed, 1), torch.stack(logits, 1), copies

    inputs, held, held_copies = run(None, torch.inference_mode)
    _, per_call, call_copies = run(inputs, torch.enable_grad)
    want_first = n_moe * per_layer
    if held_copies != [want_first] + [0] * (LM_SMALL_STEPS - 1):
        raise AssertionError(f"lm_ep_hold: slice copies a step {held_copies},"
                             f" want {want_first} then none")
    if set(call_copies) != {want_first}:
        raise AssertionError(f"lm_ep_hold: grad-mode copies a step "
                             f"{call_copies}, want {want_first} each")
    if not torch.isfinite(held).all():
        raise AssertionError("lm_ep_hold: non-finite logits")
    if not torch.equal(held, per_call):
        raise AssertionError("lm_ep_hold: held and per-call logits differ by "
                             f"{float((held - per_call).abs().max())}")
    rec = {"phase": "lm_ep_hold", "arch": cfg.name, "config": "reduced",
           "router": cfg.moe.router, "weights": "cpu",
           "mesh": mesh.describe()["shape"], "mesh_devices": str(dev),
           "steps": LM_SMALL_STEPS, "batch": LM_BATCH,
           "moe_layers": n_moe, "copies_per_layer_first_step": per_layer,
           "held_copies_per_step": held_copies,
           "grad_mode_copies_per_step": call_copies,
           "logits_bitwise_equal": True}
    emit(rec)
    return rec


def train_steps(model, steps, hp):
    """``steps`` train steps of ``model`` from a fresh AdamW state on
    ``batch_at_step`` 0, 1, ...: (the AdamW state, the last metrics)."""
    dc = DataConfig(model.cfg.vocab_size, TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(model, hp)
    for i in steps:
        m = step(opt, batch_at_step(dc, i))
    return opt, m


def hold_resume(cfg, dev, exact: bool, label: str) -> dict:
    """Checkpoint save after TRAIN_RESUME_STEPS steps, restore into a model
    built from another seed, TRAIN_RESUME_STEPS more steps: against the
    uninterrupted run on the card."""
    import shutil
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    n = TRAIN_RESUME_STEPS
    whole = Transformer(cfg, 0, device=dev)
    opt_w, _ = train_steps(whole, range(2 * n), hp)
    first = Transformer(cfg, 0, device=dev)
    opt_f, _ = train_steps(first, range(n), hp)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ckpt.save(str(TRAIN_CKPT_DIR), n, ckpt.train_state(first, opt_f))
    resumed = Transformer(cfg, 1, device=dev)
    opt_r = adamw.init(dict(resumed.named_parameters()))
    ckpt.load_train_state(resumed, opt_r, ckpt.restore(
        str(TRAIN_CKPT_DIR), ckpt.latest_step(str(TRAIN_CKPT_DIR)),
        ckpt.train_state(resumed, opt_r)))
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    step = make_train_step(resumed, hp)
    dc = DataConfig(cfg.vocab_size, TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ)
    for i in range(n, 2 * n):
        step(opt_r, batch_at_step(dc, i))
    pairs = list(zip(whole.parameters(), resumed.parameters()))
    bitwise = all(torch.equal(a, b) for a, b in pairs) and all(
        torch.equal(opt_w.m[k], opt_r.m[k]) for k in opt_w.m)
    err = max(float((a - b).detach().abs().max()) for a, b in pairs)
    if exact and not bitwise:
        raise AssertionError(f"{label}: resumed run differs from the "
                             f"uninterrupted one by {err}")
    if not exact:
        for a, b in pairs:
            torch.testing.assert_close(b, a, **TRAIN_MOE_RESUME_TOL)
    return {"bitwise": bitwise, "max_abs_err": err,
            "steps": [n, n], "step": int(opt_r.step)}


def phase_train_small_parity(dev) -> None:
    """The reduced granite and qwen2_moe (Sinkhorn router) made on the
    host from seed 0 and copied to the card: one make_train_step on each
    side (loss, ce, aux, grad_norm, lr; the clipped gradients left in
    ``.grad``), then the resume check on the card."""
    import copy
    rows = []
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    for arch, router in TRAIN_SMALL:
        cfg = small_cfg(arch, router)
        host = Transformer(cfg, 0, device="cpu")
        card = copy.deepcopy(host).to(dev)
        _, mh = train_steps(host, range(1), hp)
        _, mc = train_steps(card, range(1), hp)
        row = {"arch": arch, "router": router, "metrics": {}}
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            h, c = float(mh[k]), float(mc[k])
            if not abs(c - h) <= TRAIN_METRIC_RTOL * abs(h) + 1e-7:
                raise AssertionError(f"train_small_parity {arch} {router}: "
                                     f"{k} card {c} host {h}")
            row["metrics"][k] = {"card": c, "host": h}
        worst = 0.0
        for (name, ph), pc in zip(host.named_parameters(), card.parameters()):
            want, got = ph.grad, pc.grad.cpu()
            scale = float(want.abs().max())
            torch.testing.assert_close(
                got, want, rtol=TRAIN_GRAD_RTOL,
                atol=TRAIN_GRAD_ATOL_SHARE * scale,
                msg=lambda m: f"train_small_parity {arch} {name}: {m}")
            worst = max(worst, float((got - want).abs().max())
                        / max(scale, 1e-30))
        row["grad_max_err_share"] = worst
        row["resume"] = hold_resume(cfg, dev, exact=router is None,
                                    label=f"train_small_parity {arch} "
                                          f"{router}")
        rows.append(row)
    emit({"phase": "train_small_parity", "batch": TRAIN_SMALL_BATCH,
          "seq_len": TRAIN_SMALL_SEQ, "metric_rtol": TRAIN_METRIC_RTOL,
          "grad_rtol": TRAIN_GRAD_RTOL,
          "grad_atol_share": TRAIN_GRAD_ATOL_SHARE,
          "moe_resume_tol": TRAIN_MOE_RESUME_TOL, "archs": rows})


def train_step_flops(model, batch: int, seq: int) -> dict:
    """fp32 operations of one train step: the model FLOPs 6 N tokens
    (every parameter in one product a token, the tied embedding as the LM
    head) plus attention's 12 L B T^2 d_attn (every key block computed, as
    the reference's flash attention does: no causal skip); the recompute
    beside them: two more forwards under two-level remat and the flash
    backward's scores."""
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    d_attn = model.n_q * cfg.head_dim
    tokens = batch * seq
    attn_fwd = 4 * cfg.num_layers * batch * seq * seq * d_attn
    model_flops = 6 * n * tokens + 3 * attn_fwd
    recompute = 2 * (2 * n * tokens + attn_fwd) + attn_fwd // 2
    return {"params": n, "tokens": tokens, "model_flops": model_flops,
            "recompute_flops": recompute,
            "executed_flops": model_flops + recompute}


def phase_train_full_dense(card: str, argv=TRAIN_FULL_ARGV) -> dict:
    """granite_3_2b at full width and depth through launch/train.py's
    ``run``: per-step wall times between the hook's calls (each after the
    step's loss is read, so after its last kernel), one profiled step
    (TRAIN_PROFILE_STEP), peak memory, the model-FLOP bound."""
    from torch.profiler import ProfilerActivity, profile, schedule
    args = train_cli.build_parser().parse_args(list(argv))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stamps, metrics, probe = [], [], {}

    def hook(step, m, model):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(m[k]) for k in m})
        names = ("embed", "layers.0.attn.wq", "layers.39.mlp.w_down")
        params = dict(model.named_parameters())
        if step == 0:
            probe.update(model=model, before={
                k: params[k].detach().clone() for k in names if k in params})
        prof.step()

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=TRAIN_PROFILE_STEP - 1, warmup=1,
                                   active=1, repeat=1)) as prof:
        records = train_cli.run(args, hook=hook)
    total_s = time.perf_counter() - t0
    model = probe.pop("model")
    params = dict(model.named_parameters())
    moved = {k: not torch.equal(params[k], v)
             for k, v in probe["before"].items()}
    for m in metrics:
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"train_full_dense: non-finite {m}")
    if not moved or not all(moved.values()):
        raise AssertionError(f"train_full_dense: parameters moved {moved}")
    step_s = np.diff(stamps)                      # steps 1 .. n-1
    # the steps after the warm-up ones and before the profiler's warm-up
    timed = step_s[TRAIN_WARMUP - 1:TRAIN_PROFILE_STEP - 2]
    p50 = float(np.percentile(timed, 50))
    fl = train_step_flops(model, args.global_batch, args.seq_len)
    bound_s = fl["model_flops"] / PEAK_FP32_FLOP_PER_S
    dev_ev, host, busy_us = split_events(prof.key_averages())
    wall_us = step_s[TRAIN_PROFILE_STEP - 1] * 1e6
    prof_rec = profile_record("train_full_dense_profile", wall_us, dev_ev,
                              host, busy_us, 1)
    rec = {"phase": "train_full_dense", "arch": args.arch, "nvidia_smi": card,
           "dtype": "float32", "remat": True, "batch": args.global_batch,
           "seq_len": args.seq_len, "steps": args.steps,
           "warmup_steps_excluded": TRAIN_WARMUP,
           "params": fl["params"], "step_s": step_s.tolist(),
           "timed_steps": list(range(TRAIN_WARMUP, TRAIN_PROFILE_STEP - 1)),
           "s_per_step_p50": p50, "profiled_step": TRAIN_PROFILE_STEP,
           "tokens_per_s": fl["tokens"] / p50,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **fl, "bound_s": bound_s, "bound_share": bound_s / p50,
           "executed_share": fl["executed_flops"] / PEAK_FP32_FLOP_PER_S
           / p50, "achieved_tflops": fl["executed_flops"] / p50 / 1e12,
           "device_busy_share": prof_rec.get("device_busy_share"),
           "launches_per_step": prof_rec.get("runtime_calls_per_call"),
           "profile": prof_rec, "metrics": metrics, "records": records,
           "params_moved": moved, "total_s": total_s}
    del model, params, probe
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def phase_train_moe_sinkhorn(card: str, argv=TRAIN_MOE_ARGV) -> dict:
    """The MoE training example (examples/torch_train_moe_sinkhorn.py,
    its config and loop) on the card: the last logged ce below the first,
    both routers' drop fractions on fresh data."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "torch_train_moe_sinkhorn.py"
    spec = importlib.util.spec_from_file_location("torch_train_moe", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = example.build_parser().parse_args(list(argv))
    t0 = time.perf_counter()
    out = example.run(args)
    secs = time.perf_counter() - t0
    first, last = out["log"][0]["ce"], out["log"][-1]["ce"]
    if not last < first:
        raise AssertionError(f"train_moe_sinkhorn: ce {first} -> {last}")
    rec = {"phase": "train_moe_sinkhorn", "nvidia_smi": card,
           "steps": args.steps, "batch": args.batch, "seq_len": args.seq_len,
           "router": args.router, "params": out["n_params"],
           "seconds": secs, "s_per_step": secs / args.steps,
           "ce_first": first, "ce_last": last, "log": out["log"],
           "dropped_fraction": out["dropped"]}
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def ep_model(cfg_moe: dict, dev, seed: int = 0):
    """qwen2_moe_a2_7b at full width in fp32 from ``seed``, on ``dev``,
    its MoE spec fields replaced by ``cfg_moe``."""
    import dataclasses
    cfg = get_config("qwen2_moe_a2_7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **cfg_moe))
    gen = torch.Generator(dev).manual_seed(seed)
    return Transformer(cfg, gen, device=dev)


def timed_decode(step, cache, inputs):
    """One serve step per column of ``inputs`` (B, S), each timed to a
    sync: (logits (B, S, V), step ms, psums per step)."""
    logits, ms, psums = [], [], []
    for t in range(inputs.shape[1]):
        torch.cuda.synchronize()
        c0 = collective_counts()["psum"]
        t0 = time.perf_counter()
        _, lg, cache = step(cache, inputs[:, t:t + 1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        psums.append(collective_counts()["psum"] - c0)
        logits.append(lg)
    return torch.stack(logits, 1), ms, psums


def phase_lm_ep(dev, card: str, lm_full: dict) -> dict:
    """qwen2_moe_a2_7b (57 GB, seed 0) with its experts over LM_EP_MESH
    (every position on the card: expert slices are views): LM_STEPS serve
    steps at LM_BATCH against the same model without a mesh (top-k, no
    drops) on the same input tokens, the psums a step, the step times
    beside lm_full's; then the Sinkhorn router's per-shard semantics at
    every MoE layer."""
    cfg = get_config("qwen2_moe_a2_7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(*LM_EP_MESH, devices=[dev])
    rec = {"phase": "lm_ep", "arch": cfg.name, "nvidia_smi": card,
           "dtype": "float32", "batch": LM_BATCH, "steps": LM_STEPS,
           "mesh": mesh.describe()["shape"],
           "axis_names": list(mesh.axis_names), "mesh_devices": str(dev)}
    with torch.inference_mode():
        t0 = time.perf_counter()
        model = ep_model({"router": "topk", "capacity_factor":
                          cfg.moe.n_experts / cfg.moe.top_k}, dev)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        plain = make_serve_step(model)
        cache = model.init_cache(LM_BATCH, LM_STEPS)
        tok = torch.ones((LM_BATCH, 1), dtype=torch.long, device=dev)
        toks, want, plain_ms = [tok], [], []
        for _ in range(LM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lg, cache = plain(cache, tok)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            want.append(lg)
        want = torch.stack(want, 1)
        inputs = torch.cat(toks[:-1], 1)                 # (B, LM_STEPS)
        ep = make_serve_step(model, mesh)
        got, ep_ms, psums = timed_decode(ep, model.init_cache(
            LM_BATCH, LM_STEPS), inputs)
        if set(psums) != {cfg.num_layers}:
            raise AssertionError(f"lm_ep: psums a step {psums}, want "
                                 f"{cfg.num_layers}")
        if not torch.isfinite(got).all():
            raise AssertionError("lm_ep: non-finite logits")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=LM_EP_TOL, atol=LM_EP_TOL):
            raise AssertionError(f"lm_ep: EP logits differ by {err}")
        a, b = np.asarray(ep_ms[2:]), np.asarray(plain_ms[2:])
        rec.update(max_abs_err=err, tol=LM_EP_TOL, psums_per_step=psums[0],
                   ms_per_token_p50=float(np.percentile(a, 50)),
                   ms_per_token_p99=float(np.percentile(a, 99)),
                   first_steps_ms=ep_ms[:2],
                   plain_topk_ms_p50=float(np.percentile(b, 50)),
                   plain_topk_ms_p99=float(np.percentile(b, 99)),
                   lm_full_ms_p50=lm_full["ms_per_token_p50"],
                   lm_full_ms_p99=lm_full["ms_per_token_p99"],
                   tokens_per_s=LM_BATCH / (a.mean() / 1e3))
        # the config's Sinkhorn router and capacity: every layer's MoE
        # input at one decode step, through the EP layer and the non-EP
        # layer per data shard
        set_moe(model, router=cfg.moe.router,
                capacity_factor=cfg.moe.capacity_factor)
        inputs_moe = []
        hooks = [blk.moe.register_forward_pre_hook(
            lambda _m, args: inputs_moe.append(args[0]))
            for blk in model.layers]
        model.decode_step(model.init_cache(LM_BATCH, 2), inputs[:, :1])
        for h in hooks:
            h.remove()
        n_data = LM_EP_MESH[0][0]
        per = LM_BATCH // n_data
        worst = 0.0
        for i, (blk, x) in enumerate(zip(model.layers, inputs_moe)):
            out, _ = moe_apply_ep(blk.moe, x, mesh)
            for s in range(n_data):
                ref_out, _ = blk.moe(x[s * per:(s + 1) * per])
                torch.testing.assert_close(
                    out[s * per:(s + 1) * per], ref_out,
                    rtol=LM_EP_SHARD_TOL, atol=LM_EP_SHARD_TOL,
                    msg=lambda m: f"lm_ep sinkhorn layer {i} shard {s}: {m}")
                worst = max(worst, float((out[s * per:(s + 1) * per]
                                          - ref_out).abs().max()))
        rec["sinkhorn_per_shard"] = {"layers": len(inputs_moe),
                                     "max_abs_err": worst,
                                     "tol": LM_EP_SHARD_TOL}
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del model, cache
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def phase_train_ep_small_parity(dev) -> None:
    """The reduced qwen2_moe train step with its experts over a (2, 4)
    mesh: on the card (positions on the card) against the host (positions
    on the host) with the config's Sinkhorn router (metrics, gradients);
    and on the card, EP gradients against the non-EP ones with the top-k
    router at a capacity that drops nothing. Two data shards average
    per-shard switch losses (the reference's EP aux), so that comparison
    takes the cross-entropy alone (aux weight 0). train_small_parity's
    tolerances."""
    import copy
    import dataclasses
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(small_cfg("qwen2_moe_a2_7b").vocab_size,
                    TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ)
    batch = batch_at_step(dc, 0)
    rows = []

    def grads(model, mesh, hp):
        opt = adamw.init(dict(model.named_parameters()))
        m = make_train_step(model, hp, mesh)(opt, batch)
        return {k: float(v) for k, v in m.items()}, {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    def hold(got, want, label):
        worst = 0.0
        for name, w in want.items():
            scale = float(w.abs().max())
            torch.testing.assert_close(
                got[name], w, rtol=TRAIN_GRAD_RTOL,
                atol=TRAIN_GRAD_ATOL_SHARE * scale,
                msg=lambda m: f"train_ep_small_parity {label} {name}: {m}")
            worst = max(worst, float((got[name] - w).abs().max())
                        / max(scale, 1e-30))
        return worst

    cfg = small_cfg("qwen2_moe_a2_7b", "sinkhorn")
    host = Transformer(cfg, 0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    mh, gh = grads(host, make_mesh(*DIST_MESH, devices=["cpu"]), hp)
    mc, gc = grads(card, make_mesh(*DIST_MESH, devices=[dev]), hp)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        if not abs(mc[k] - mh[k]) <= TRAIN_METRIC_RTOL * abs(mh[k]) + 1e-7:
            raise AssertionError(f"train_ep_small_parity: {k} card "
                                 f"{mc[k]} host {mh[k]}")
    rows.append({"check": "card_vs_host", "router": "sinkhorn",
                 "metrics": {k: {"card": mc[k], "host": mh[k]} for k in mc},
                 "grad_max_err_share": hold(gc, gh, "card_vs_host")})
    base = small_cfg("qwen2_moe_a2_7b", "topk")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
    hp0 = dataclasses.replace(hp, aux_loss_weight=0.0)
    plain = Transformer(cfg, 0, device="cpu").to(dev)
    ep = copy.deepcopy(plain)
    mp, gp = grads(plain, None, hp0)
    me, ge = grads(ep, make_mesh(*DIST_MESH, devices=[dev]), hp0)
    for k in ("loss", "ce", "grad_norm"):
        if not abs(me[k] - mp[k]) <= TRAIN_METRIC_RTOL * abs(mp[k]) + 1e-7:
            raise AssertionError(f"train_ep_small_parity: {k} EP {me[k]} "
                                 f"non-EP {mp[k]}")
    rows.append({"check": "ep_vs_plain", "router": "topk",
                 "capacity_factor": cfg.moe.capacity_factor,
                 "aux_loss_weight": 0.0,
                 "metrics": {k: {"ep": me[k], "plain": mp[k]} for k in me},
                 "grad_max_err_share": hold(ge, gp, "ep_vs_plain")})
    emit({"phase": "train_ep_small_parity", "mesh": list(DIST_MESH[0]),
          "batch": TRAIN_SMALL_BATCH, "seq_len": TRAIN_SMALL_SEQ,
          "metric_rtol": TRAIN_METRIC_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
          "grad_atol_share": TRAIN_GRAD_ATOL_SHARE, "checks": rows})


def phase_dryrun(card: str, train: dict) -> dict:
    """The dry-run's whole meta sweep (cells and seconds), then the FLOP
    counter against a measured step: torch_cost of the granite_3_2b
    train step at train_full_dense's shape (fp32, tp 1, remat) over that
    phase's measured p50 must stay under the card's fp32 peak."""
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    res = dryrun_cli.sweep(str(DRYRUN_DIR), force=True, log=lambda _: None)
    if res["failures"] or res["cells"] != DRYRUN_CELLS \
            or res["skipped"] != DRYRUN_SKIPPED:
        raise AssertionError(f"dryrun: sweep {res}")
    cells = [json.loads(p.read_text()) for p in sorted(
        DRYRUN_DIR.glob("*.json"))]
    walked = [c for c in cells if "skipped" not in c]
    if not all(c["fits_80gb"] and c["torch_cost"]["flops"] > 0
               for c in walked):
        raise AssertionError("dryrun: a cell does not fit or counts no "
                             "FLOPs")
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    args = train_cli.build_parser().parse_args(list(TRAIN_FULL_ARGV))
    cfg = get_config(args.arch)
    t0 = time.perf_counter()
    walk = dryrun_cli.train_walk(args.global_batch, args.seq_len, 1, None,
                                 TrainHParams(), tp=1, dtype=torch.float32)
    cost = stacked_cost(cfg, walk, remat=True)
    walk_s = time.perf_counter() - t0
    p50 = train["s_per_step_p50"]
    rate = cost.flops / p50
    if not rate < PEAK_FP32_FLOP_PER_S:
        raise AssertionError(f"dryrun: {cost.flops} FLOP in {p50} s is "
                             f"{rate} FLOP/s, above the fp32 peak")
    rec = {"phase": "dryrun", "nvidia_smi": card,
           "cells": res["cells"], "skipped": res["skipped"],
           "sweep_s": res["seconds"],
           "walk_s_max": max(c["walk_s"] for c in walked),
           "fits_80gb": sum(c["fits_80gb"] for c in walked),
           "granite_train_step": {
               "batch": args.global_batch, "seq_len": args.seq_len,
               "remat": True, "dtype": "float32",
               "torch_cost_flops": cost.flops,
               "matmul_flops": sum(v for k, v in cost.by_op.items()
                                   if k in ("mm", "bmm", "addmm",
                                            "baddbmm")),
               "estimate_executed_flops": train["executed_flops"],
               "model_flops": train["model_flops"],
               "measured_s_per_step_p50": p50,
               "flop_per_s": rate, "share_of_fp32_peak":
                   rate / PEAK_FP32_FLOP_PER_S, "walk_s": walk_s}}
    emit(rec)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()

    t0 = time.perf_counter()
    corpus = paper_corpus(seed=0)
    index = build_index(corpus.docs, corpus.vecs, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "index", "seconds": time.perf_counter() - t0,
          "n_docs": index.n_docs, "vocab": index.vocab_size,
          "embed_dim": index.embed_dim, "max_words": index.docs.idx.shape[1],
          "groups": len(index.groups)})

    # the paper's widest queries (48 support rows), then the widest chunk
    # the main path itself stages for this corpus; the kernels line below
    # reports the latter
    sup, r, mask = paper_chunk(index.vocab_size, dev)
    phase_k2(index, sup, mask, "paper_max")
    phase_k1(index, sup, r, mask, False, 1.0, "paper_max")
    phase_k1(index, sup, r, mask, True, CONFIG.lam, "paper_max")
    sup, r, mask = main_path_chunk(corpus, index)
    k2 = phase_k2(index, sup, mask, "main_path")
    k1_lin = phase_k1(index, sup, r, mask, False, 1.0, "main_path")
    k1_log = phase_k1(index, sup, r, mask, True, CONFIG.lam, "main_path")
    phase_k1_tiles(index, sup, r, mask)
    k1_ad = phase_k1_adaptive(index, sup, r, mask, "main_path")
    phase_k1_bf16(index, sup, r, mask)
    phase_k1_wide(index, dev, K1_CROSSOVER_SWEEP
                  if "--k1-crossover-sweep" in sys.argv[1:] else K1_CROSSOVER)
    # more live rows than one stacked group of 128 (two groups); more queries
    # than one stacked launch's 64, as refine stages every query of a
    # search (fig15's stream has 128) in one tensor
    phase_k2(index, *paper_chunk(index.vocab_size, dev, width=200, q=2,
                                 seed=2)[::2], "wide_200")
    phase_k2(index, *paper_chunk(index.vocab_size, dev, q=128,
                                 seed=6)[::2], "queries_128")
    torch.cuda.empty_cache()

    # the one-query kernels on the first paper query (and K3 on a
    # 200-word query, four row tiles)
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    docs = device_docs(corpus.docs, dev)
    r0, sel0, _ = select_support(widest_query(corpus), vecs)
    k3 = phase_k3(vecs, sel0, r0, "widest_paper_query")
    rng = np.random.default_rng(4)
    wide = torch.as_tensor(rng.choice(vecs.shape[0], 200, replace=False),
                           device=dev)
    rw = rng.uniform(0.1, 1.0, 200)
    phase_k3(vecs, vecs[wide].contiguous(),
             torch.as_tensor(rw / rw.sum(), dtype=torch.float32, device=dev),
             "wide_200")
    k4 = phase_k4(vecs, docs, r0, sel0)
    k3_bf16 = phase_k3_bf16(vecs, sel0, r0)
    k4_ad = phase_k4_adaptive(vecs, docs, r0, sel0)
    k5 = phase_k5(vecs, docs, r0, sel0)
    k6 = phase_k6(vecs, docs, r0, sel0)
    del vecs, docs
    torch.cuda.empty_cache()

    phase_small_parity(dev)
    e2e_log = phase_end_to_end(corpus, index, "log", CONFIG.lam)
    phase_end_to_end(corpus, index, "fp32", 1.0)
    phase_profile(corpus, index)
    phase_underflow(corpus, index)
    phase_einsum(corpus, index)
    phase_profile(corpus, index, impl="sparse")
    phase_kcache(corpus, index)
    # more queries than one stacked block serves (64), still one launch,
    # against as many candidate words as the 10-query stage has
    sup, _, mask = paper_chunk(index.vocab_size, dev, q=128, seed=6)
    vids = torch.as_tensor(np.sort(np.random.default_rng(7).choice(
        index.vocab_size, 53_862, replace=False)), device=dev)
    k2s_128 = phase_k2s(index, sup, mask, vids, "queries_128")
    smi = info["nvidia_smi"]
    t_serve = time.perf_counter()
    # K2s at the shapes serving gives it on this corpus: one query a
    # dispatch at light load, and a cascade that keeps almost every doc,
    # so a candidate vocabulary of tens of thousands of words
    k2s_serve = phase_k2s_from_search(index, [[q] for q in corpus.queries],
                                      "serve_one_query")
    serve = phase_serve(corpus, index, smi)
    phase_serve_faults(corpus, index, serve["capacity_1_per_s"], smi)
    phase_serve_kcache(index, smi)
    phase_profile_serve(corpus, index, serve["capacity_per_s"], smi)
    emit({"phase": "serving", "seconds": time.perf_counter() - t_serve})
    t_shards = time.perf_counter()
    shards = phase_shards(corpus, index, smi)
    two = shards["engines"][2]
    k2s_shards = shards["k2s"]["single"]
    k2s_shard_stages = {key: r for key, r in shards["k2s"].items()
                        if key != "single"}
    shard_k2s_launches = {
        n: srec["prunes"][SHARD_PRUNES[0]]["launches"]["summed"][
            "rwmd_min_cdist_subset"]
        for n, srec in shards["record"]["shards"].items()}
    del shards
    phase_shard_snapshot(corpus, two, smi)
    phase_serve_shards(corpus, index, two, smi)
    phase_distributed(corpus, smi)
    import shutil
    shutil.rmtree(SHARD_SNAPSHOT_DIR, ignore_errors=True)
    del two
    emit({"phase": "sharding", "seconds": time.perf_counter() - t_shards})
    del index
    torch.cuda.empty_cache()
    otm = phase_one_to_many(corpus, dev)
    torch.cuda.empty_cache()
    phase_many_to_many(corpus, dev)
    phase_profile_one_to_many(corpus, dev)
    oq_ad = phase_one_query_adaptive(corpus, dev)
    del corpus
    torch.cuda.empty_cache()

    # the IVF cascade, refine and appends on the dedup corpus
    dedup, dindex, build_s = build_dedup(dev)
    k2s = phase_k2s_from_search(dindex, [list(dedup.queries)],
                                "cascade_search")
    # queries wider than one K2s pass of 128 support rows (two passes in
    # the block), against 2048 candidate words
    sup, _, mask = paper_chunk(dindex.vocab_size, dev, width=200, q=2,
                               seed=3)
    vids = torch.as_tensor(np.random.default_rng(5).choice(
        dindex.vocab_size, 2048, replace=False), device=dev)
    k2s_wide = phase_k2s(dindex, sup, mask, vids, "wide_200")
    casc = phase_cascade(dedup, dindex, build_s)
    phase_profile_cascade(dedup, dindex)
    phase_k1_adaptive(dindex, *main_path_chunk(dedup, dindex), "dedup_chunk")
    adapt = phase_adaptive(dedup, dindex)
    phase_warm_start(dedup, dindex)
    del dindex
    torch.cuda.empty_cache()
    phase_append(dedup, dev)
    phase_wmd_defaults(dev)
    del dedup
    torch.cuda.empty_cache()

    # the LM decode server: reduced models on the card against the host,
    # then qwen2_moe_a2_7b (57 GB), granite_3_2b, rwkv6_3b (11 GB) and
    # zamba2_7b (27 GB) at full width, then LM_WIDE
    t_lm = time.perf_counter()
    phase_lm_small_parity(dev)
    smi = info["nvidia_smi"]
    lm_full = phase_lm_full(dev, "qwen2_moe_a2_7b", "lm_full", smi)
    phase_lm_full(dev, "granite_3_2b", "lm_full_dense", smi)
    phase_lm_full(dev, "rwkv6_3b", "lm_full_ssm", smi)
    phase_lm_full(dev, "zamba2_7b", "lm_full_hybrid", smi)
    # the five archs the card had not run, one after the other
    for arch, phase, layers in LM_WIDE:
        phase_lm_full(dev, arch, phase, smi, layers)
    emit({"phase": "lm", "seconds": time.perf_counter() - t_lm})

    # training: the reduced models on the card against the host (and
    # resume from a checkpoint), granite_3_2b at full width through
    # launch/train.py, the MoE example's 100 steps
    t_train = time.perf_counter()
    phase_train_small_parity(dev)
    train_full = phase_train_full_dense(smi)
    phase_train_moe_sinkhorn(smi)
    emit({"phase": "train", "seconds": time.perf_counter() - t_train})

    # expert parallelism over a (2, 4) mesh of positions on the card (and
    # with the weights on the host: slices held on the card), then the
    # dry-run's meta sweep and the FLOP counter against the measured
    # granite step
    t_ep = time.perf_counter()
    phase_lm_ep(dev, smi, lm_full)
    phase_lm_ep_hold(dev)
    phase_train_ep_small_parity(dev)
    phase_dryrun(smi, train_full)
    emit({"phase": "ep_dryrun", "seconds": time.perf_counter() - t_ep})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    path_launches = {**otm["launches_per_kernel_call"],
                     "rwmd_min_cdist": e2e_log["launches"]["rwmd_min_cdist"],
                     "sinkhorn_fused_all_batched":
                         e2e_log["launches"]["sinkhorn_fused_all_batched"],
                     "sddmm_spmm_step":
                         k5["path"]["launches"]["sddmm_spmm_step"],
                     "rwmd_min_cdist_subset":
                         casc["launches_per_search"]["rwmd_min_cdist_subset"]}
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = []
    for rec, src, replaces in (
            (k2, "rwmd_min_cdist.cu", "src/repro/kernels/rwmd.py:54"),
            (k1_log, "sinkhorn_fused.cu",
             "src/repro/kernels/sddmm_spmm.py:263"),
            (k3[1], "cdist_exp.cu", "src/repro/kernels/cdist_exp.py:60"),
            (k4[0], "sinkhorn_fused.cu",
             "src/repro/kernels/sddmm_spmm.py:202"),
            (k5, "sddmm_spmm_step.cu", "src/repro/kernels/sddmm_spmm.py:76"),
            (k2s, "rwmd_min_cdist.cu", "src/repro/kernels/rwmd.py:83")):
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": path_launches[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library": rec["library"], "shape": rec["shape"],
            "launch_ms": rec["launch_ms"]})
    # K1's entry is the search path's log-domain lam=10 solve, K3's and
    # K4's the one_to_many(impl="kernel") path's fp32 lam=1 calls, K2s's
    # the widest RWMD stage of a log "ivf+wcd+rwmd" search of the dedup
    # queries (its launches: per such search); other variants ride along
    # under their own keys
    keys = ("max_abs_err", "ms", "launch_ms", "plain_ms", "bound_ms",
            "bound_by")
    kernels[1]["fp32_lam1"] = {key: k1_lin[key] for key in keys}
    # the kernel K2s's launcher picks at each shape
    kernels[5]["subset_route"] = k2s["subset_route"]
    # K2s at the widest RWMD stage of a one-query search of the paper
    # corpus (what a served request runs); its launches: the light-load
    # serving run's
    light = serve["runs"]["0.25C1"]
    kernels[5]["serve_one_query"] = {
        **{key: k2s_serve[key] for key in keys}, "shape": k2s_serve["shape"],
        "subset_route": k2s_serve["subset_route"], "library_ms": None,
        "launches": light["launches"]["rwmd_min_cdist_subset"],
        "launches_per_dispatch":
            light["launches_per_dispatch"]["rwmd_min_cdist_subset"]}
    # K2s at the widest RWMD stage of the single engine's cascade search of
    # the 10 paper queries (the sharded searches' shapes, each shard's
    # held in phase shards); its launches: per sharded search, by S
    kernels[5]["shards_paper_queries"] = {
        **{key: k2s_shards[key] for key in keys},
        "shape": k2s_shards["shape"],
        "subset_route": k2s_shards["subset_route"],
        "library_ms": None,
        "launches_per_sharded_search": shard_k2s_launches}
    # K2s at every shard's widest RWMD stage (S = 1, 2, 4), at 128 queries,
    # and at queries wider than one group of 128 support rows
    kernels[5]["shard_stages"] = {
        key: {**{k: r[k] for k in keys}, "shape": r["shape"],
              "subset_route": r["subset_route"], "library_ms": None}
        for key, r in k2s_shard_stages.items()}
    kernels[5]["queries_128"] = {
        **{key: k2s_128[key] for key in keys}, "shape": k2s_128["shape"],
        "subset_route": k2s_128["subset_route"], "library_ms": None}
    kernels[5]["wide_200"] = {
        **{key: k2s_wide[key] for key in keys}, "shape": k2s_wide["shape"],
        "subset_route": k2s_wide["subset_route"], "library_ms": None}
    # K2's product alone on cuBLAS SGEMM as a yardstick
    kernels[0]["sgemm_ms"] = k2["sgemm_ms"]
    kernels[2]["full"] = {key: k3[0][key] for key in keys}
    kernels[2]["log_k_lam10"] = {key: k3[2][key] for key in keys}
    kernels[3]["log_lam10"] = {key: k4[1][key] for key in keys}
    # K5: the 15-step path's device time, and a 200-word query
    kernels[4]["path_ms"] = k5["path"]["ms"]
    kernels[4]["query_200"] = {
        **{key: k5["query_200"][key] for key in keys},
        "shape": k5["query_200"]["shape"], "library_ms": None}
    # the adaptive and bf16 modes: K1's adaptive exit on the main path's
    # widest chunk, launched by an adaptive "ivf+wcd+rwmd" search of the
    # dedup queries; K3's and K4's bf16 operands and K4's adaptive exit,
    # launched by the one-query kernel path with precision="bf16" / tol
    kernels[1]["adaptive_fig10"] = {
        **{key: k1_ad[key] for key in keys}, "plain_ms": k1_ad["plain_ms"],
        "fixed_ms": k1_ad["fixed_ms"], "fixed_bound_ms":
            k1_ad["fixed_bound_ms"],
        "mean_live_doc_iters": k1_ad["mean_live_doc_iters"],
        "library_ms": None,
        "launches": adapt["launches_per_search"][
            "sinkhorn_fused_all_batched"]}
    kernels[2]["bf16_k_only"] = {
        **{key: k3_bf16[0][key] for key in keys}, "library_ms": None,
        "launches": oq_ad["launches"]["bf16"]["cdist_exp"]}
    for mode, launches in (("adaptive", oq_ad["launches"]["adaptive"]),
                           ("bf16_fixed", oq_ad["launches"]["bf16"])):
        kernels[3][mode] = {**{key: k4_ad[mode][key] for key in keys},
                            "library_ms": None,
                            "launches": launches["sinkhorn_fused_all"]}
    # K6: its path (ops.bsr_sddmm, the kernel gathering its
    # panels) at 128 x 128 tiles; the 64 x 64 tiles and the entry point on
    # given panels ride along, and the dense c * (kt @ u) under its own key
    k6_rec = k6["128x128"]
    kernels.append({
        "name": "bsr_sddmm_blocks", "route": "cuda",
        "source": csrc + "bsr_sddmm.cu",
        "replaces": "src/repro/kernels/bsr_sddmm.py:35",
        "launches": k6_rec["launches"],
        **{key: k6_rec[key] for key in keys}, "library_ms": None,
        "library": k6_rec["library"], "shape": k6_rec["shape"],
        "block_density": k6_rec["block_density"],
        "dense_ms": k6_rec["dense_ms"], "dense": k6_rec["dense"],
        "blocks_entry": k6_rec["blocks_entry"],
        "tiles_64x64": {**{key: k6["64x64"][key] for key in keys},
                        "block_density": k6["64x64"]["block_density"],
                        "shape": k6["64x64"]["shape"],
                        "dense_ms": k6["64x64"]["dense_ms"],
                        "library_ms": None,
                        "launches": k6["64x64"]["launches"]}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
