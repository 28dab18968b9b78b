"""attn_bwd_roofline_pct: the attention backward's least time over every
layer of the traced steps (its five products, 2.5 times the forward's,
whichever route runs; ``work.attention_bound_ms``) over rank 0's summed
device time of the flash backward kernels (the fused one, or dq and
dk/dv)."""

from benchmark.harness.work import attention_bound_ms


def read(run):
    t = run["trace"]
    ms = t and t["kernel_ms"].get("attn_bwd")
    if run["platform"] != "gpu" or not ms:
        return None
    bound = attention_bound_ms(run["config"], run["local_batch"],
                               run["seq_len"], "bwd") * t["steps"]
    return 100.0 * bound / ms
