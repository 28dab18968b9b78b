"""tokens_per_s: B·T of every step of the window (the global batch
counted once), over the window's wall time on the host clock, from its
start to the synchronize after its last step."""


def read(run):
    if run["platform"] != "gpu":
        return None
    tokens = run["steps"] * run["global_batch"] * run["seq_len"]
    return tokens / run["wall_s"]
