"""setup_s (host clock): from the start of the process to the first
measured call: imports, the CUDA context, the seeded corpus, the build or
load of the program's kernels, the index and the warm-up of every shape
the cell's pool makes."""


def read(run):
    return run.setup_s
