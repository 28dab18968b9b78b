"""A ``torch.profiler`` trace of a window of training steps.

The trainers' ``--profile-dir`` (the JAX examples' ``jax.profiler``
trace): steps ``start+1 .. start+steps`` are traced, the first step,
which builds and loads the kernels, left out, and the trace is written
as Chrome JSON (``chrome://tracing``, Perfetto), one file per rank.  The
port's spans (``spans``) are on while it traces, so the trace carries
their ``ptt.*`` ranges beside the operators and the kernels.
"""

from __future__ import annotations

import contextlib
import os

import torch

from pytorch_operator_tpu_torch.telemetry import spans


class StepTrace:
    def __init__(self, directory: str | None, steps: int, start: int,
                 device: torch.device, rank: int):
        self.directory, self.rank, self.device = directory, rank, device
        self.first, self.last = start + 1, start + steps
        self.on = directory is not None and steps >= 1
        self.prof = None
        self._spans = contextlib.ExitStack()

    def before(self, i: int) -> None:
        """Call before step ``i``: starts the trace at the first step."""
        if self.on and i == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._spans.enter_context(spans.enabled())

    def after(self, i: int) -> None:
        """Call after step ``i``: writes the trace after the last step."""
        if self.prof is not None and i == self.last:
            self.stop()

    def stop(self) -> None:
        """Write the trace now if one is running (a run shorter than the
        window)."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._spans.close()
        spans.take_counts()  # the trace carries the spans, not counts
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"trace_rank{self.rank}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print(f"profile trace written to {path}", flush=True)
