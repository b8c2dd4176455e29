"""Time design variants of K3 (cdist_exp) and K2s (rwmd_min_cdist_subset)
side by side on one card, in one process.

    python3 tools/time_kernel_variants.py

Each variant is the committed source with a few lines replaced (VARIANTS
below). Every variant is compiled by nvcc into a library of its own under
build/kernel_variants/ (all builds started together) and timed at the
shapes its path gives it: K3 on one query of 16, 23, 43 and 64 words
against the paper vocabulary (V = 100 000, w = 300), K2s at a cascade
RWMD stage (4 queries of 24 support rows, one of them filler, 128 candidate
words with a repeated tail) and at 2 queries of 200 rows against 2048
words. Two variants of each kernel time parts of it and give wrong
results: "stage_only" skips the FFMAs (the ring and the epilogue), and
"compute_only" stages the first chunk alone (the FFMAs and the epilogue).
The others are checked against the committed kernel. Prints the card's
name and power limit, then one JSON object per timing: the mean device
time of 30 launches run back to back behind a held stream, in ms.
"""
from __future__ import annotations

import ctypes
import json
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

K3_SRC, K2S_SRC = "cdist_exp.cu", "rwmd_min_cdist.cu"
K3_TV64 = (K3_SRC, "return BMAX <= 32 ? 64 : 128;", "return 64;")
K3_TV128 = (K3_SRC, "return BMAX <= 32 ? 64 : 128;", "return 128;")
K3_STAGES3 = (K3_SRC, "constexpr int kStages = 2;",
              "constexpr int kStages = 3;")
K3_NO_FMA = (K3_SRC, "    if (live) {\n      cdist_ring::prep_rows",
             "    if (live && W < 0) {\n      cdist_ring::prep_rows")
K3_ONE_STAGE = (K3_SRC, "    if (next < n_chunks)\n",
                "    if (next < 1)\n")
K2S_NO_FMA = (K2S_SRC, "      if (live) {\n        cdist_ring::prep_rows",
              "      if (live && W < 0) {\n        cdist_ring::prep_rows")
K2S_ONE_STAGE = (K2S_SRC, "      if (next < n_chunks)\n        cdist_ring",
                 "      if (next < 1)\n        cdist_ring")


def k2s_warps(n):
    return (K2S_SRC, "constexpr int kSubWarps = 16;",
            f"constexpr int kSubWarps = {n};")


def k2s_stages(n):
    return (K2S_SRC, "constexpr int kSubStages = 2;",
            f"constexpr int kSubStages = {n};")


# (kernel, variant) -> replacements (file, old, new); "committed" is none
VARIANTS = {
    ("k3", "committed"): [], ("k3", "tv64"): [K3_TV64],
    ("k3", "tv128"): [K3_TV128], ("k3", "stages3"): [K3_STAGES3],
    ("k3", "stage_only"): [K3_NO_FMA], ("k3", "compute_only"): [K3_ONE_STAGE],
    ("k2s", "committed"): [], ("k2s", "warps8"): [k2s_warps(8)],
    ("k2s", "warps8_stages4"): [k2s_warps(8), k2s_stages(4)],
    ("k2s", "stages4"): [k2s_stages(4)],
    ("k2s", "stage_only"): [K2S_NO_FMA],
    ("k2s", "compute_only"): [K2S_ONE_STAGE],
}
WRONG = ("stage_only", "compute_only")
HOLD_CYCLES = 50_000_000
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_all() -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for (kernel, name), subs in VARIANTS.items():
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
        src = K3_SRC if kernel == "k3" else K2S_SRC
        procs[(kernel, name)] = subprocess.Popen(
            [nvcc, *FLAGS, str(d / src), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(OUT / f"{key[0]}_{key[1]}" / "lib.so"))
    return libs


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


def run_k2s(libs, vecs, gen) -> None:
    v, w = vecs.shape
    dev = vecs.device
    stream = P(torch.cuda.current_stream().cuda_stream)
    for label, q, bq, vc, live in (("cascade", 4, 24, 128, (23, 19, 21, 0)),
                                   ("wide_200", 2, 200, 2048, (200, 150))):
        a = vecs[torch.randint(0, v, (q, bq), generator=gen).to(dev)]
        a = a.contiguous()
        mask = torch.zeros((q, bq), device=dev)
        for i, n in enumerate(live):
            mask[i, :n] = 1.0
        ids = torch.randint(0, v, (vc,), generator=gen).to(dev)
        ids[-vc // 3:] = ids[0]                 # a padded tail
        out = torch.empty((q, vc), device=dev)
        want = None
        for (kernel, name), lib in libs.items():
            if kernel != "k2s":
                continue
            fn = lib.rwmd_min_cdist_subset_launch
            fn.argtypes = [P] * 5 + [I] * 5 + [P]

            def call():
                return fn(ptr(a), ptr(mask), ptr(vecs), ptr(ids), ptr(out),
                          q, bq, w, v, vc, stream)
            if call() != 0:
                raise RuntimeError(f"k2s {name}: launch failed")
            torch.cuda.synchronize()
            if name == "committed":
                want = out.clone()
            elif name not in WRONG and not torch.equal(out, want):
                raise AssertionError(f"k2s {name} differs from committed")
            print(json.dumps({"kernel": "rwmd_min_cdist_subset",
                              "variant": name, "inputs": label, "Q": q,
                              "B": bq, "Vc": vc, "w": w,
                              "ms": time_ms(call, reps=50)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    vecs = torch.randn((100_000, 300), generator=gen).to("cuda")
    run_k3(libs, vecs, gen)
    run_k2s(libs, vecs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
