"""step_ms_p95: the 95th percentile over all of the window's steps of the
interval between consecutive step-boundary CUDA events on rank 0's
stream (device clock; a host stall shows as a longer interval)."""

from benchmark.harness.job import p95


def read(run):
    if run["platform"] != "gpu" or not run["step_ms"]:
        return None
    return p95(run["step_ms"])
