"""expert_load_max_ratio: the busiest expert's routed tokens over the
mean expert's, from the port's ``expert_tokens`` counter
(``models/moe.py`` ``moe_ffn``: each expert's top-k picks, summed over
the data ranks), averaged over the layers and the traced steps, on rank
0 (a layer a checkpoint recomputes is counted twice, alike).

Under the dense dispatch every expert runs on every token, so this does
not move ``tokens_per_s`` yet: a change in it means the routing
changed.  Once the dispatch is sparse, the busiest expert sets the
layer's pace, by this factor over a balanced load."""


def read(run):
    t = run["trace"]
    calls = t and t.get("expert_tokens")
    if run["platform"] != "gpu" or not calls:
        return None
    ratios = [max(c) * len(c) / sum(c) for c in calls if sum(c) > 0]
    return sum(ratios) / len(ratios) if ratios else None
