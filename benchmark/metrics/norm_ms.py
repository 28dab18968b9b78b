"""norm_ms: rank 0's device ms a step of the kernels launched in the
port's ``norm`` span (``models/llama.py`` ``rms_norm``: every RMSNorm,
B5's forward and its plain-torch backward, ``ops/rms_norm.py``),
forward, recompute and backward (``harness/spans.py``)."""

from benchmark.harness.spans import ms_per_step


def read(run):
    return ms_per_step(run, "norm")
