"""The control of the correctness check, and the program's readings, for
one cell over several seeds in one process (not part of a benchmark run).

    python bench/control.py --workload <cell> --seeds 11 12 13 \
        [--program-seconds 2]

For each seed: the control puts the plain reference computed with the
distance product in TF32 (the precision below the configuration's fp32
with TF32 off) in the program's place, on the run's own data and sample
size, and prints its readings against the fp32 reference; with
``--program-seconds`` it also runs the cell itself (a short window) and
prints the program's readings. The limits in a cell's file lie between
the program's largest and the control's smallest reading (PERF.md).
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell_name: str, seed: int, device="cuda") -> dict:
    """The widest of each compared number when the TF32 reference answers
    ``sample`` queries of the pool in place of the program."""
    import torch
    from bench.traffic.generate import STREAM_SAMPLE, rng
    from bench.wmdbench import cell as cells
    from bench.wmdbench.check import readings, reference_distances
    cell = cells.resolve(cell_name)
    entry = cells.entry_module(cell.traffic)
    corpus = cells.make_corpus(cell.config, seed, torch.device(device))
    n = int(cell.spec["check"]["sample"])
    pos = rng(seed, STREAM_SAMPLE).choice(corpus.pool.n, n, replace=False)
    k = int(cell.traffic.get("k", 0))
    ctl = reference_distances(pos, corpus, cell.config, cell.traffic,
                              tf32=True)
    ref = reference_distances(pos, corpus, cell.config, cell.traffic)
    return readings([entry.from_distances(d, k) for d in ctl], ref,
                    entry.compare, k)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program-seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.wmdbench.harness import dumps, run
    for seed in args.seeds:
        t = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed,
               "control": control_readings(args.workload, seed, args.device)}
        if args.program_seconds > 0:
            r = run(args.workload, seed, args.program_seconds, False,
                    time.perf_counter(),
                    device=None if args.device == "cuda" else args.device)
            rec["program"] = {k: v["value"] for k, v in r["checks"].items()}
            rec["program_correct"] = r["correct"]
        rec["seconds"] = time.perf_counter() - t
        print(dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
