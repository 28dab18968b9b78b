"""global_norm_ms: rank 0's device ms a step of the kernels launched in
the port's ``global_norm`` span (``parallel/train.py`` ``_make_step``:
every gradient's f32 sum of squares and their reductions;
``harness/spans.py``)."""

from benchmark.harness.spans import ms_per_step


def read(run):
    return ms_per_step(run, "global_norm")
