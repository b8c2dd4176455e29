"""Time design variants of K1's live-tile kernel (sinkhorn_fused_all_batched
past 64 x 64), K3 (cdist_exp), K2s (rwmd_min_cdist_subset) and K5
(sddmm_spmm_step) side by side on one card, in one process.

    python3 tools/time_kernel_variants.py [k1] [k3] [k2s] [k5]

K1 runs on news20_knn's corpus (bench/configs/news20_knn.json, drawn by the
benchmark's generator from seed 0) at the engine's chunks of 64 pool
queries: the committed live-tile kernel (persistent blocks that pack pairs
into their arena, launched by live size: the pairs that fit half the
arena at two blocks an SM, then the rest at one; a third launch streams
the pairs over the arena), "one_launch" (one packing launch at one block
an SM for every size that fits), "one_pair" (packing one pair a round)
and "t256" (256 threads and 8 pairs a round), beside the
device-memory variant that "auto" ran before, on the widest group at the
median and the widest chunk, then over every (chunk, group) of the call
past 64 x 64. Every variant's distances equal the committed kernel's
(t256: within 1e-5).

Each variant is the committed source with a few lines replaced (VARIANTS
below). Every variant is compiled by nvcc into a library of its own under
build/kernel_variants/ (all builds started together) and timed at the
shapes its path gives it: K3 on one query of 16, 23, 43 and 64 words
against the paper vocabulary (V = 100 000, w = 300); K5 on the G and G/r
of the paper corpus (N = 5000, L = 28) for its widest query (v_r = 23)
and for a 200-word query. K2s runs every route at the shapes of
K2S_SHAPES, built on the card from seed 0 at the Q, B, live rows and Vc
that chip_smoke.py's phase k2s captures from cascade searches, plus one
call of 128 queries: the committed launcher (routed), PR 17's kernel (a
block per query and 32 columns), K2's stacked kernel over the gathered
rows, K2 over all of V followed by index_select of the Vc columns, and
the plain version, each held to the plain version's output; then both
kernels across the sweep of Vc that sets the route's switch. Some K3 and
K5 variants time parts of a kernel and give wrong results: "stage_only"
(K3) and "loads_only" (K5) skip the FFMAs (K5: sums the loaded values
instead), "compute_only" stages the first chunk alone (K3) or loads no G
or G/r (K5). The others are checked against the committed kernel. Prints
the card's name and power limit, one JSON object per compiled kernel
instance of each variant (registers a thread and spill bytes, from ptxas
-v), then one per timing: the mean device time of 30 launches (K2s: 50,
the plain version 5) run back to back behind a held stream, in ms; K2s
times each route twice, in turns.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_variants"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared"]

K1_SRC, K3_SRC, K2S_SRC, K5_SRC = ("sinkhorn_fused.cu", "cdist_exp.cu",
                                    "rwmd_min_cdist.cu", "sddmm_spmm_step.cu")
SRC = {"k1": K1_SRC, "k3": K3_SRC, "k2s": K2S_SRC, "k5": K5_SRC}
# K1's live-tile kernel packing one pair a round (a block per pair)
K1_ONE_PAIR = (K1_SRC, "          if (off + f > arena_floats) break;",
               "          if (taken > 0 || off + f > arena_floats) break;")
K1_T256 = [(K1_SRC, "constexpr int kLThreads = 512;",
            "constexpr int kLThreads = 256;"),
           (K1_SRC, "constexpr int kLPairs = 16; ",
            "constexpr int kLPairs = 8; ")]
# one launch at one block an SM, the whole arena, for pairs of every size
K1_ONE_LAUNCH = [
    (K1_SRC, "__global__ void __launch_bounds__(kLThreads, 2)\n"
             "sinkhorn_fused_live_kernel(",
     "__global__ void __launch_bounds__(kLThreads, 1)\n"
     "sinkhorn_fused_live_kernel("),
    (K1_SRC, """  int blocks = (int)(pairs < room2 ? pairs : room2);
  kernel<<<blocks, kLThreads, (size_t)half * 4, stream>>>(
      a.g, a.val, a.r, a.resmask, a.wmd, a.iters, a.work, a.ext, 1, nullptr,
      nullptr, a.stats, a.Q, a.VR, a.N, a.L, a.n_iter, a.lam, a.log_domain,
      a.block_n, a.tol, a.check_every, half, 0, half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blocks =""", """  int blocks ="""),
    (K1_SRC, "a.work + 1, a.ext, 0, over,", "a.work + 1, a.ext, 1, over,"),
    (K1_SRC, "a.check_every, arena, half, arena);",
     "a.check_every, arena, 0, arena);")]

K3_TV64 = (K3_SRC, "return BMAX <= 32 ? 64 : 128;", "return 64;")
K3_TV128 = (K3_SRC, "return BMAX <= 32 ? 64 : 128;", "return 128;")
K3_STAGES3 = (K3_SRC, "constexpr int kStages = 2;",
              "constexpr int kStages = 3;")
K3_NO_FMA = (K3_SRC, "    if (live) {\n      cdist_ring::prep_rows",
             "    if (live && W < 0) {\n      cdist_ring::prep_rows")
K3_ONE_STAGE = (K3_SRC, "    if (next < n_chunks)\n",
                "    if (next < 1)\n")
# K2s's routing rule forced to one kernel: PR 17's block per (query, 32
# columns), or K2's stacked kernel over the gathered rows
K2S_RULE = "  return (long long)Q * tiles >= kStRouteTiles * groups;"
K2S_PR17 = (K2S_SRC, K2S_RULE, "  return false;")
K2S_STACKED = (K2S_SRC, K2S_RULE, "  return true;")
# the stacked kernel without its 32-row groups (64 rows at most 64 support
# rows, as K2 had it)
K2S_NO_RB32 = (K2S_SRC, "  if (rows <= 32) return launch_stacked_rb<32>(x, "
               "stream);\n", "")
# the stacked kernel with groups of 64 rows at most (more blocks a wave,
# more passes over the tile)
K2S_RB64 = (K2S_SRC, "  return launch_stacked_rb<128>(x, stream);",
            "  return launch_stacked_rb<64>(x, stream);")
# the stacked kernel's ring alone (no FFMAs), or its FFMAs on the first
# chunk alone (wrong results: they time parts of the kernel)
K2S_STAGE_ONLY = (K2S_SRC, "      if (active) {\n        for (int j = 0;",
                  "      if (active && W < 0) {\n        for (int j = 0;")
K2S_COMPUTE_ONLY = (K2S_SRC, "      if (ch + 1 < n_chunks) stage(",
                    "      if (ch + 1 < 1) stage(")
# the stacked kernel's FFMAs with the x, y, z and w terms of 8 columns in
# turn (8 independent FFMAs between dependent ones; each sum in the same
# order, so the same bits)
K2S_ILP = (K2S_SRC, """            for (int c = 0; c < 8; ++c) {
              acc[r][c] = fmaf(av.x, bv[c].x, acc[r][c]);
              acc[r][c] = fmaf(av.y, bv[c].y, acc[r][c]);
              acc[r][c] = fmaf(av.z, bv[c].z, acc[r][c]);
              acc[r][c] = fmaf(av.w, bv[c].w, acc[r][c]);
            }
""", """            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(av.x, bv[c].x, acc[r][c]);
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(av.y, bv[c].y, acc[r][c]);
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(av.z, bv[c].z, acc[r][c]);
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(av.w, bv[c].w, acc[r][c]);
""")


K5_LIM = "const int lim = ONE ? __reduce_max_sync(kFull, L) : L;"
# G/r read only up to each doc's last val != 0 (w = 0 past it; equal to
# the committed kernel where G/r is finite and no w past it is NaN, as on
# the inputs here)
K5_GR_LIVE_EXTENT = [
    (K5_SRC, "    for (int l0 = 0; l0 < (ONE ? 1 : L); l0 += 32) {       "
             "// SDDMM\n",
     "    int last = -1;\n"
     "    for (int l0 = 0; l0 < (ONE ? 1 : L); l0 += 32) {       // SDDMM\n"),
    (K5_SRC, "      const float v = on ? val[(size_t)n * L + l] : 0.f;\n",
     "      const float v = on ? val[(size_t)n * L + l] : 0.f;\n"
     "      if (v != 0.f) last = l;\n"),
    (K5_SRC, K5_LIM, "const int lim = __reduce_max_sync(kFull, last) + 1;")]
# lim = L known to the compiler (no reduction), also behind a compiler
# memory barrier; the reduction on the any-shape loops too
K5_LIM_PLAIN = [(K5_SRC, K5_LIM, "const int lim = L;")]
K5_LIM_ASM = [(K5_SRC, K5_LIM,
               "const int lim = L;\n    asm volatile(\"\" ::: \"memory\");")]
K5_LIM_REDUX_ALL = [(K5_SRC, K5_LIM,
                     "const int lim = __reduce_max_sync(kFull, L);")]
# the doc's G/r asked into L2 before its SDDMM (G and G/r in flight
# together; registers would hold both only at half the warps)
K5_GR_PREFETCH = (
    K5_SRC, "    for (int l0 = 0; l0 < (ONE ? 1 : L); l0 += 32) {       "
            "// SDDMM\n",
    "    for (int l = lane; l < L; l += 32)\n"
    "      for (int k = 0; k < VR; ++k)\n"
    "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(grn + k * nl"
    " + l));\n"
    "    for (int l0 = 0; l0 < (ONE ? 1 : L); l0 += 32) {       // SDDMM\n")
K5_NO_FMA = [
    (K5_SRC, "          t0 = fmaf(col[k], __shfl_sync(kFull, uk, k), t0);\n"
             "          t1 = fmaf(col[k + 1], __shfl_sync(kFull, uk, k + 1), "
             "t1);",
     "          t0 += col[k];\n          t1 += col[k + 1];"),
    (K5_SRC, "        s += transpose_sum(p, lane);",
     "#pragma unroll\n        for (int k = 0; k < 32; ++k) s += p[k];")]
K5_NO_LOAD = [(K5_SRC, "gn[(k0 + k) * nl + l]", "(float)(k0 + k)"),
              (K5_SRC, "grn[(k0 + k) * nl + l]", "(float)(k0 + k)")]


def k5_min_blocks(n, wide):
    return (K5_SRC, "constexpr int kMinBlocks = 10, kMinBlocksWide = 8;",
            f"constexpr int kMinBlocks = {n}, kMinBlocksWide = {wide};")


# (kernel, variant) -> replacements (file, old, new); "committed" is none
VARIANTS = {
    ("k1", "committed"): [], ("k1", "one_launch"): K1_ONE_LAUNCH,
    ("k1", "one_pair"): [K1_ONE_PAIR], ("k1", "t256"): K1_T256,
    ("k3", "committed"): [], ("k3", "tv64"): [K3_TV64],
    ("k3", "tv128"): [K3_TV128], ("k3", "stages3"): [K3_STAGES3],
    ("k3", "stage_only"): [K3_NO_FMA], ("k3", "compute_only"): [K3_ONE_STAGE],
    ("k2s", "committed"): [], ("k2s", "pr17"): [K2S_PR17],
    ("k2s", "stacked"): [K2S_STACKED],
    ("k2s", "stacked_no_rb32"): [K2S_STACKED, K2S_NO_RB32],
    ("k2s", "stacked_ilp"): [K2S_STACKED, K2S_ILP],
    ("k2s", "stacked_rb64"): [K2S_STACKED, K2S_RB64],
    ("k2s", "stage_only"): [K2S_STACKED, K2S_STAGE_ONLY],
    ("k2s", "compute_only"): [K2S_STACKED, K2S_COMPUTE_ONLY],
    ("k5", "committed"): [], ("k5", "gr_live_extent"): K5_GR_LIVE_EXTENT,
    ("k5", "lim_plain"): K5_LIM_PLAIN, ("k5", "lim_asm"): K5_LIM_ASM,
    ("k5", "lim_redux_all"): K5_LIM_REDUX_ALL,
    ("k5", "gr_prefetch_l2"): [K5_GR_PREFETCH],
    ("k5", "min_blocks1"): [k5_min_blocks(1, 1)],
    ("k5", "min_blocks8_6"): [k5_min_blocks(8, 6)],
    ("k5", "loads_only"): K5_NO_FMA, ("k5", "compute_only"): K5_NO_LOAD,
    # the loops over row chunks and slot classes at any VR and L; one
    # tile of 32 rows (spills at 48 registers) where VR <= 24
    ("k5", "generic"): [(K5_SRC, "L > 32 || VR > 24 ?", "true ?")],
    ("k5", "rows32"): [(K5_SRC, "launch<24, true>", "launch<32, true>")],
}
WRONG = ("stage_only", "compute_only", "loads_only")
HOLD_CYCLES = 50_000_000
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_all(kernels) -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for (kernel, name), subs in VARIANTS.items():
        if kernel not in kernels:
            continue
        d = OUT / f"{kernel}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
            text = f.read_text()
            for fname, old, new in subs:
                if fname == f.name:
                    if old not in text:
                        raise ValueError(f"{kernel} {name}: {old!r} not in "
                                         f"{fname}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
        procs[(kernel, name)] = subprocess.Popen(
            [nvcc, *FLAGS, "-Xptxas", "-v", str(d / SRC[kernel]), "-o",
             str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        print_resources(key, out)
        libs[key] = ctypes.CDLL(str(OUT / f"{key[0]}_{key[1]}" / "lib.so"))
    return libs


def print_resources(key, ptxas: str) -> None:
    """One JSON line per kernel instance from ptxas -v: its registers a
    thread and its spill bytes."""
    for entry in re.split(r"Compiling entry function '", ptxas)[1:]:
        name = entry.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        print(json.dumps({
            "kernel": key[0], "variant": key[1], "instance": name,
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None}),
            flush=True)


def time_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
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


def ptr(t: torch.Tensor) -> P:
    return P(t.data_ptr())


def run_k3(libs, vecs, gen) -> None:
    v, w = vecs.shape
    stream = P(torch.cuda.current_stream().cuda_stream)
    for v_r in (16, 23, 43, 64):
        pick = torch.randperm(v, generator=gen)[:v_r].to(vecs.device)
        a = vecs[pick].contiguous()
        r = torch.full((v_r,), 1.0 / v_r, device=vecs.device)
        k = torch.empty((v_r, v), device=vecs.device)
        m, kr = torch.empty_like(k), torch.empty_like(k)
        for mode, (mp, krp, bf16) in (("k_only", (P(None), P(None), 0)),
                                      ("full", (ptr(m), ptr(kr), 0)),
                                      ("bf16_k_only", (P(None), P(None), 1))):
            want = None
            for (kernel, name), lib in libs.items():
                if kernel != "k3":
                    continue
                fn = lib.cdist_exp_launch
                fn.argtypes = [P] * 6 + [I] * 3 + [F, I, I, P]

                def call():
                    return fn(ptr(a), ptr(vecs), ptr(r), mp, ptr(k), krp,
                              v_r, w, v, F(1.0), 0, bf16, stream)
                if call() != 0:
                    raise RuntimeError(f"k3 {name}: launch failed")
                torch.cuda.synchronize()
                if name == "committed":
                    want = k.clone()
                elif name not in WRONG and not torch.equal(k, want):
                    raise AssertionError(f"k3 {name} differs from committed")
                print(json.dumps({"kernel": "cdist_exp", "variant": name,
                                  "v_r": v_r, "w": w, "V": v, "mode": mode,
                                  "ms": time_ms(call)}), flush=True)


# K2s at the shapes chip_smoke.py's phase k2s captures from real cascade
# searches (its "shape" records on an H100: Q, B, live rows per query, Vc):
# the widest RWMD stage of the paper corpus's 10 queries (the single
# engine's, and so every sharded search's: 16 padded queries, six of them
# filler), of each shard's at S = 2 and 4, of a one-query (served)
# search, of the dedup corpus's search, and 2 queries of 200 rows against
# 2048 words; then more queries than one stacked block's 64
PAPER_10 = (12, 16, 17, 17, 18, 18, 19, 21, 21, 23) + (0,) * 6
K2S_SHAPES = {
    "shards_single": (16, 24, PAPER_10, 53_862),
    "shards_S2_shard0": (16, 24, PAPER_10, 33_553),
    "shards_S2_shard1": (16, 24, PAPER_10, 29_608),
    "shards_S4_shard1": (16, 24, PAPER_10, 20_307),
    "shards_S4_shard2": (16, 24, PAPER_10, 8_105),
    "shards_S4_shard3": (16, 24, PAPER_10, 2_766),
    "serve_one_query": (1, 24, (21,), 54_381),
    "cascade_search": (4, 24, (12, 16, 16, 17), 81),
    "wide_200": (2, 200, (200, 43), 2048),
    "queries_128": (128, 24, PAPER_10, 53_862),
}
# the switch's sweep: the two kernels at Q of 1 to 16 (live rows as the
# paper queries', the rest filler) against Vc candidate words
K2S_SWEEP_Q = {1: (21,), 2: (21, 12), 4: (12, 16, 16, 17),
               8: PAPER_10[:8], 16: PAPER_10}
K2S_SWEEP_VC = (1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 32768)


def k2s_inputs(vecs, gen, q, bq, live, vc):
    """a (q, bq, w) rows of vecs, a mask with live[i % len(live)] rows of
    query i live, and vc distinct sorted ids."""
    v = vecs.shape[0]
    dev = vecs.device
    a = vecs[torch.randint(0, v, (q, bq), generator=gen).to(dev)]
    mask = torch.zeros((q, bq), device=dev)
    for i in range(q):
        mask[i, :min(bq, live[i % len(live)])] = 1.0
    ids = torch.randperm(v, generator=gen)[:vc].sort().values.to(dev)
    return a.contiguous(), mask, ids


def hold_k2s(name, got, want, a, mask, bsel) -> float:
    """chip_smoke.py's check: the same +inf pattern and each finite entry
    within 1e-5 of |a|^2max + |b|^2 in squared distance; returns the
    largest absolute error."""
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"k2s {name}: inf pattern differs from plain")
    fin = torch.isfinite(want)
    a2max = torch.where(mask > 0, (a * a).sum(-1),
                        torch.zeros_like(mask)).max(dim=1).values
    scale = a2max[:, None] + (bsel * bsel).sum(-1)[None, :]
    if ((got * got - want * want).abs() > 1e-5 * scale)[fin].any():
        raise AssertionError(f"k2s {name}: outside the tolerance of plain")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def run_k2s(libs, vecs, gen) -> None:
    """Every route of K2s at each shape, in turns (each route twice, the
    second pass in reverse order): each k2s variant (the committed, routed
    launcher; PR 17's kernel; the stacked kernel and its variants), K2
    over all of V then index_select of the Vc columns, and the plain
    version; then PR 17's and the stacked kernel over the switch's
    sweep."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    v, w = vecs.shape
    stream = P(torch.cuda.current_stream().cuda_stream)
    subset = {}
    for (kernel, name), lib in libs.items():
        if kernel == "k2s":
            fn = lib.rwmd_min_cdist_subset_launch
            fn.argtypes = [P] * 5 + [I] * 5 + [P]
            subset[name] = fn
    k2 = libs["k2s", "committed"].rwmd_min_cdist_launch
    k2.argtypes = [P] * 4 + [I] * 4 + [P]
    route = libs["k2s", "committed"].rwmd_min_cdist_subset_stacked
    route.argtypes = [I] * 3

    def routes(a, mask, ids, out):
        q, bq, _ = a.shape
        vc = ids.numel()
        full = torch.empty((q, v), device=vecs.device)
        calls = {name: (lambda fn=fn: fn(ptr(a), ptr(mask), ptr(vecs),
                                          ptr(ids), ptr(out), q, bq, w, v,
                                          vc, stream))
                 for name, fn in subset.items()}

        def k2_gather():
            if k2(ptr(a), ptr(mask), ptr(vecs), ptr(full), q, bq, w, v,
                  stream) != 0:
                raise RuntimeError("k2s k2_gather: launch failed")
            torch.index_select(full, 1, ids, out=out)
            return 0

        def plain():
            out.copy_(ref.rwmd_min_cdist_subset_ref(a, mask, vecs, ids))
            return 0
        calls["k2_gather"] = k2_gather
        calls["plain"] = plain
        return calls

    for label, (q, bq, live, vc) in K2S_SHAPES.items():
        a, mask, ids = k2s_inputs(vecs, gen, q, bq, live, vc)
        out = torch.empty((q, vc), device=vecs.device)
        calls = routes(a, mask, ids, out)
        want = ref.rwmd_min_cdist_subset_ref(a, mask, vecs, ids)
        errs, same, first = {}, {}, None
        for name, call in calls.items():
            out.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"k2s {name}: launch failed")
            torch.cuda.synchronize()
            if name in WRONG:
                continue
            errs[name] = hold_k2s(name, out, want, a, mask, vecs[ids])
            first = out.clone() if first is None else first
            same[name] = torch.equal(out, first)
        times = {name: [] for name in calls}
        order = list(calls)
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(time_ms(calls[name], reps=5 if name ==
                                           "plain" else 50))
        print(json.dumps({
            "kernel": "rwmd_min_cdist_subset", "inputs": label, "Q": q,
            "B": bq, "live_rows": int(mask.sum()), "Vc": vc, "w": w,
            "route": "stacked" if route(q, bq, vc) else "per_query",
            "ms": {n: sum(t) / len(t) for n, t in times.items()},
            "ms_each": times, "max_abs_err": errs,
            "bitwise_equal_to_committed": same}), flush=True)
    for q, live in K2S_SWEEP_Q.items():
        for vc in K2S_SWEEP_VC:
            a, mask, ids = k2s_inputs(vecs, gen, q, 24, live, vc)
            out = torch.empty((q, vc), device=vecs.device)
            calls = routes(a, mask, ids, out)
            times = {"pr17": [], "stacked": []}
            for names in (list(times), list(times)[::-1]):
                for name in names:
                    times[name].append(time_ms(calls[name], reps=50))
            print(json.dumps({
                "kernel": "rwmd_min_cdist_subset", "inputs": "sweep",
                "Q": q, "B": 24, "live_rows": int(mask.sum()), "Vc": vc,
                "tiles": -(-vc // 128),
                "route": "stacked" if route(q, 24, vc) else "per_query",
                "ms": {n: sum(t) / len(t) for n, t in times.items()}}),
                flush=True)


def k5_inputs():
    """The paper corpus's doc matrix (N = 5000, L = 28) and the G and G/r
    of its widest query (v_r = 23) and of 200 random vocabulary words, as
    chip_smoke.py's phase k5 makes them."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core.sinkhorn import select_support
    from repro_torch.core.sinkhorn_sparse import precompute_sparse
    from repro_torch.core.sparse import PaddedDocs
    from repro_torch.data.corpus import paper_corpus
    corpus = paper_corpus(seed=0)
    dev = torch.device("cuda")
    vecs = torch.as_tensor(corpus.vecs, device=dev)
    docs = PaddedDocs(idx=torch.as_tensor(corpus.docs.idx, dtype=torch.int64,
                                          device=dev),
                      val=torch.as_tensor(corpus.docs.val, device=dev))
    widest = max(corpus.queries, key=lambda q: int((q > 0).sum()))
    r, sel, _ = select_support(widest, vecs)
    rng = np.random.default_rng(4)
    wide = torch.as_tensor(rng.choice(vecs.shape[0], 200, replace=False),
                           device=dev)
    rw = rng.uniform(0.1, 1.0, 200)
    r200 = torch.as_tensor(rw / rw.sum(), dtype=torch.float32, device=dev)
    return {"widest_paper_query": precompute_sparse(r, sel, vecs, docs, 1.0),
            "query_200": precompute_sparse(r200, vecs[wide].contiguous(),
                                           vecs, docs, 1.0)}


def run_k5(libs) -> None:
    stream = P(torch.cuda.current_stream().cuda_stream)
    for label, pre in k5_inputs().items():
        v_r, n, length = pre.G.shape
        x = torch.full((v_r, n), 1.0 / v_r, device=pre.G.device)
        out = torch.empty_like(x)
        want = None
        for (kernel, name), lib in libs.items():
            if kernel != "k5":
                continue
            fn = lib.sddmm_spmm_step_launch
            fn.argtypes = [P] * 5 + [I] * 3 + [P]

            def call():
                return fn(ptr(pre.G), ptr(pre.G_over_r), ptr(pre.val),
                          ptr(x), ptr(out), v_r, n, length, stream)
            if call() != 0:
                raise RuntimeError(f"k5 {name}: launch failed")
            torch.cuda.synchronize()
            if name == "committed":
                want = out.clone()
            elif name not in WRONG and not torch.equal(out, want):
                raise AssertionError(f"k5 {name} differs from committed")
            print(json.dumps({"kernel": "sddmm_spmm_step", "variant": name,
                              "inputs": label, "v_r": v_r, "N": n,
                              "L": length, "ms": time_ms(call)}),
                  flush=True)


def k1_chunks():
    """news20_knn's engine (as bench/entries/search.py builds it) on its
    corpus from seed 0, and the staged K block of every chunk of 64 pool
    queries: (engine, [(width, qp, kq), ...])."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from bench.traffic.generate import DenseRows, make
    from repro_torch.core.index import WmdEngine, build_index
    from repro_torch.core.sparse import PaddedDocs
    config = json.loads((ROOT / "bench" / "configs" /
                         "news20_knn.json").read_text())
    corpus = make(config, 0, "cuda")
    eng = dict(config["engine"])
    groups = eng.pop("doc_groups")
    index = build_index(PaddedDocs(idx=corpus.idx, val=corpus.val),
                        corpus.vecs, device="cuda", doc_groups=groups)
    engine = WmdEngine(index, lam=config["lam"], n_iter=config["n_iter"],
                       **eng)
    rows = list(DenseRows(64, config["vocab_size"]).fill(corpus.pool,
                                                         range(64)))
    _, chunks = engine._plan(rows)
    out = []
    for chunk, width in chunks:
        sup, r, mask = engine._prep_chunk([rows[i] for i in chunk], width)
        out.append((width, r, engine._kq(sup, mask)[0]))
    return engine, out


def run_k1(libs) -> None:
    engine, chunks = k1_chunks()            # puts src/ on the path
    from repro_torch.core.index import _gather_g
    stream = P(torch.cuda.current_stream().cuda_stream)
    lam, n_iter = engine.lam, engine.n_iter
    arena = 228_352

    def launcher(lib, g, val, r, variant):
        q, v_r, n, length = g.shape
        fn = lib.sinkhorn_fused_batched_launch
        fn.argtypes = [P] * 9 + [I] * 5 + [F, I, I, F, I, I, I, I, P]
        wmd = torch.empty((q, n), device=g.device)

        def call():
            # the three work counters (zeroed) and two ints a pair, as ops
            work = torch.zeros(3, dtype=torch.int32, device=g.device)
            ext = torch.empty(2 * q * n, dtype=torch.int32, device=g.device)
            return fn(ptr(g), ptr(val), ptr(r), P(None), ptr(wmd), P(None),
                      ptr(work), ptr(ext), P(None), q, v_r, n, length,
                      n_iter, F(lam), 1, 128, F(0.0), 0, 0, variant, arena,
                      stream)
        return call, wmd

    def designs():
        for (kernel, name), lib in libs.items():
            if kernel == "k1":
                yield name, lib, 0
                if name == "committed":
                    yield "device_memory", lib, 3

    widths = sorted(w for w, _, _ in chunks)
    pick = {"median_chunk": widths[len(widths) // 2],
            "widest_chunk": widths[-1]}
    grp = engine.index.groups[-1]
    for label, width in pick.items():
        _, r, kq = next(c for c in chunks if c[0] == width)
        g = _gather_g(kq, grp.docs.idx)
        want = None
        for name, lib, variant in designs():
            call, wmd = launcher(lib, g, grp.docs.val, r, variant)
            if call() != 0:
                raise RuntimeError(f"k1 {name}: launch failed")
            torch.cuda.synchronize()
            if want is None:
                want = wmd.clone()
            elif name == "device_memory" or name == "t256":
                torch.testing.assert_close(wmd, want, rtol=1e-5, atol=1e-5,
                                           equal_nan=True)
            elif not torch.equal(wmd.nan_to_num(), want.nan_to_num()):
                raise AssertionError(f"k1 {name} differs from committed")
            print(json.dumps({"kernel": "sinkhorn_fused_all_batched",
                              "variant": name, "inputs": label,
                              "shape": list(g.shape),
                              "ms": time_ms(call, reps=5)}), flush=True)
        del g
    # every (chunk, group) of the call past 64 x 64: K1's wide work a call
    total = {}
    for width, r, kq in chunks:
        for grp in engine.index.groups:
            if width <= 64 and grp.docs.idx.shape[1] <= 64:
                continue
            g = _gather_g(kq, grp.docs.idx)
            for name, lib, variant in designs():
                call, _ = launcher(lib, g, grp.docs.val, r, variant)
                total[name] = total.get(name, 0.0) + time_ms(call, reps=2)
            del g
    for name, ms in total.items():
        print(json.dumps({"kernel": "sinkhorn_fused_all_batched",
                          "variant": name, "inputs": "call_64_queries",
                          "ms": ms}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    kernels = set(sys.argv[1:]) or set(SRC)
    if not kernels <= set(SRC):
        print(f"time_kernel_variants: kernels are {sorted(SRC)}",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_all(kernels)
    if "k1" in kernels:
        run_k1(libs)
    gen = torch.Generator().manual_seed(0)
    vecs = torch.randn((100_000, 300), generator=gen).to("cuda")
    if "k3" in kernels:
        run_k3(libs, vecs, gen)
    if "k2s" in kernels:
        run_k2s(libs, vecs, gen)
    del vecs
    if "k5" in kernels:
        run_k5(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
