"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process sees and
prints one JSON line as the last line of its output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
the per-layer metrics and a ``breakdown``). Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or
when JAX or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host path runs numpy and small torch
# ops, which thread pools only make jitter
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache the run writes stays at fixed paths in the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.wmdbench.harness import (Failure, dumps, forbidden_modules,
                                        run)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), T_START)
        if forbidden_modules():
            raise Failure(f"loaded by the run: {forbidden_modules()}")
    except Failure as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
