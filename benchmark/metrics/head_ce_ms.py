"""head_ce_ms: rank 0's device ms a step of the kernels launched in the
port's ``head_ce`` span: the tied head and its f32 logits
(``models/llama.py`` ``tied_logits``) and the cross entropy, chunked or
not (``parallel/train.py`` ``tied_ce``), forward, recompute and backward
(``harness/spans.py``)."""

from benchmark.harness.spans import ms_per_step


def read(run):
    return ms_per_step(run, "head_ce")
