"""attention_ms: rank 0's device ms a step of the kernels launched in
the port's ``attention`` span (``models/llama.py`` ``attend`` after its
norm: the q/k/v projections, RoPE, the flash kernels or the sequence-
parallel attention, the o-projection), forward, recompute and backward
(``harness/spans.py``)."""

from benchmark.harness.spans import ms_per_step


def read(run):
    return ms_per_step(run, "attention")
