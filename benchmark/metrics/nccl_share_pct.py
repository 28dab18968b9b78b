"""nccl_share_pct: rank 0's NCCL kernels' device time over all its
kernels' in the traced steps (a transfer that overlaps compute counts
in both)."""


def read(run):
    t = run["trace"]
    nccl = t and t["kernel_ms"].get("nccl")
    if run["platform"] != "gpu" or not nccl:
        return None
    return 100.0 * nccl / t["total_kernel_ms"]
