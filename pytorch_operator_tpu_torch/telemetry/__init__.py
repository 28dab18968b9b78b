"""Data-plane telemetry: per-step timing, tokens/s and MFU.

Port of ``pytorch_operator_tpu/telemetry``' step profiler
(``step_timer``), the trainer side of the push path to the operator
(``push``: ``PushClient``, whose ``on_record`` takes the profiler's
records), the trainers' ``torch.profiler`` trace of a window of steps
(``trace``), and the spans and counters inside the port that such a
trace carries while they are on (``spans``).
"""

from pytorch_operator_tpu_torch.telemetry.step_timer import (
    PEAK_FLOPS_PER_CHIP,
    StepProfiler,
    StepRecord,
    peak_flops_per_chip,
    read_step_log,
    train_step_flops,
)

__all__ = ["PEAK_FLOPS_PER_CHIP", "StepProfiler", "StepRecord",
           "peak_flops_per_chip", "read_step_log", "train_step_flops"]
