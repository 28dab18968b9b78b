"""device_idle_pct: the share of rank 0's traced window (its first
device record's start to its last one's end) in which no kernel or copy
runs."""


def read(run):
    t = run["trace"]
    if run["platform"] != "gpu" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
