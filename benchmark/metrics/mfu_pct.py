"""mfu_pct: the model FLOPs of the traced steps (``work.model_flops``:
6·N·B·T + 12·L·B·T²·D/2, N the routed parameters, recompute not
counted, attention once however many ranks repeat it) over their
device-clock time on rank 0 (step-boundary events) and the cards' peak
(989 TFLOP/s each)."""

from benchmark.harness.work import PEAK_BF16_FLOPS, model_flops


def read(run):
    t = run["trace"]
    if run["platform"] != "gpu" or not t or t["device_ms"] <= 0:
        return None
    flops = model_flops(run["config"], run["global_batch"],
                        run["seq_len"]) * t["steps"]
    return 100.0 * flops / (t["device_ms"] / 1e3) / (
        PEAK_BF16_FLOPS * run["chips"])
