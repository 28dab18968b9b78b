"""attn_fwd_roofline_pct: the attention forward's least time over every
layer of the traced steps (``work.attention_bound_ms``: the larger of its
tensor-core, exponential and byte terms at the published peaks) over
rank 0's summed device time of the flash forward kernels."""

from benchmark.harness.work import attention_bound_ms


def read(run):
    t = run["trace"]
    ms = t and t["kernel_ms"].get("attn_fwd")
    if run["platform"] != "gpu" or not ms:
        return None
    bound = attention_bound_ms(run["config"], run["local_batch"],
                               run["seq_len"], "fwd") * t["steps"]
    return 100.0 * bound / ms
