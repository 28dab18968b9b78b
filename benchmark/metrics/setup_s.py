"""setup_s: from the run's start, before any import, to the first timed
step on rank 0: imports, the kernel library's load (or build), the
weights, the check steps and the warm-up."""


def read(run):
    return run["setup_s"]
