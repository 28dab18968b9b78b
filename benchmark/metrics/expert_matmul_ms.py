"""expert_matmul_ms: rank 0's device time a step of the experts'
products: the kernels ``aten::bmm`` launches, forward and backward
(``models/moe.py`` ``moe_ffn`` runs every expert as one bmm)."""


def read(run):
    t = run["trace"]
    if run["platform"] != "gpu" or not t or not t["bmm_ms"]:
        return None
    return t["bmm_ms"] / t["steps"]
