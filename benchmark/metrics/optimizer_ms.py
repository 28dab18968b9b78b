"""optimizer_ms: rank 0's device time a step of the kernels launched under
the profiler's ``Optimizer.step`` range (AdamW)."""


def read(run):
    t = run["trace"]
    if run["platform"] != "gpu" or not t or not t["optimizer_ms"]:
        return None
    return t["optimizer_ms"] / t["steps"]
