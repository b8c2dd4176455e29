"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library with
a plain C interface under ``build/repro_torch/`` at the repository root;
``csrc/*.cuh`` holds device code that sources share. The library's file
name carries a hash of the sources, headers and flags, so an edited file
is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the kernels rely on IEEE inf/NaN and full-precision
# expf/logf/sqrtf to match their fp32 plain versions
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):      # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwmd_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile and link the kernels unless the library for these sources
    exists. Returns (library path, nvcc's combined output: ptxas register
    and shared-memory report)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib, "\n".join(logs)


def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C signatures."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rwmd_min_cdist_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.rwmd_min_cdist_launch.restype = i
    lib.rwmd_min_cdist_subset_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                 i, p]
    lib.rwmd_min_cdist_subset_launch.restype = i
    lib.rwmd_min_cdist_subset_stacked.argtypes = [i, i, i]
    lib.rwmd_min_cdist_subset_stacked.restype = i
    lib.sinkhorn_fused_batched_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, f, i, i, i, i,
        p]
    lib.sinkhorn_fused_batched_launch.restype = i
    lib.sinkhorn_fused_smem_bytes.argtypes = [i, i, i, i]
    lib.sinkhorn_fused_smem_bytes.restype = ctypes.c_longlong
    lib.sinkhorn_fused_live_floats.argtypes = [i, i]
    lib.sinkhorn_fused_live_floats.restype = ctypes.c_longlong
    lib.cdist_exp_launch.argtypes = [p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.cdist_exp_launch.restype = i
    lib.sddmm_spmm_step_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.sddmm_spmm_step_launch.restype = i
    lib.sddmm_spmm_step_smem_bytes.argtypes = [i]
    lib.sddmm_spmm_step_smem_bytes.restype = ctypes.c_longlong
    lib.bsr_sddmm_blocks_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.bsr_sddmm_blocks_launch.restype = i
    lib.bsr_sddmm_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.bsr_sddmm_launch.restype = i
    return lib
