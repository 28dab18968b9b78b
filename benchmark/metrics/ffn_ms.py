"""ffn_ms: rank 0's device ms a step of the kernels launched in the
port's ``ffn`` span: the SwiGLU of ``models/llama.py`` ``Block`` after
its norm, or ``models/moe.py`` ``moe_ffn`` (router, the experts' bmm,
the combine and the ep all-reduce), forward, recompute and backward
(``harness/spans.py``)."""

from benchmark.harness.spans import ms_per_step


def read(run):
    return ms_per_step(run, "ffn")
