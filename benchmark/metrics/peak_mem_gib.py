"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` of the fullest
rank, reset after the weights are made (so they count), read when the
window closes."""


def read(run):
    if run["platform"] != "gpu" or run["peak_bytes"] is None:
        return None
    return run["peak_bytes"] / 2 ** 30
