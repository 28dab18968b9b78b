"""The trace reduction on a made-up trace: classes, busy and idle time,
the optimizer's kernels by its range on the device, the experts' by the
operator that launched them, and idle gaps by what the host was doing."""

from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

import tiny_cells  # noqa: F401  (puts the checkout on the path)
from benchmark.harness import profile


def _ev(name, start, end, device=DeviceType.CUDA, annotation=False,
        kernels=(), parent=None):
    return NS(name=name, device_type=device, is_user_annotation=annotation,
              is_async=False, time_range=NS(start=start, end=end),
              kernels=[NS(duration=d) for d in kernels], cpu_parent=parent)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _trace():
    step = _ev("step", 0, 100, DeviceType.CPU)
    opt = _ev("Optimizer.step#AdamW.step", 60, 100, DeviceType.CPU,
              parent=step)
    bmm = _ev("aten::bmm", 5, 8, DeviceType.CPU, kernels=[20.0],
              parent=step)
    slow = _ev("aten::nonzero", 40, 55, DeviceType.CPU, parent=step)
    return _Prof([
        step, opt, bmm, slow,
        _ev("nvjet_tst_gemm", 10, 30),
        _ev("void flash_fwd_sm90_kernel<bf16>", 30, 40),
        _ev("ncclDevKernel_AllReduce", 35, 45),      # overlaps
        _ev("multi_tensor_apply_kernel", 62, 70),    # in the range
        _ev("Optimizer.step#AdamW.step", 61, 71, annotation=True),
        _ev("void flash_bwd_dq_sm90_kernel<bf16>", 80, 90),
    ])


def test_summarize_a_made_up_trace():
    got = profile.summarize(_trace(), steps=2)
    assert got["kernel_ms"] == pytest.approx({
        "matmul": 0.020, "attn_fwd": 0.010, "nccl": 0.010,
        "other": 0.008, "attn_bwd": 0.010})
    assert got["optimizer_ms"] == pytest.approx(0.008)
    assert got["bmm_ms"] == pytest.approx(0.020)
    # busy: [10, 45] + [62, 70] + [80, 90]; spanned: [10, 90]
    assert got["busy_s"] == pytest.approx(53e-6)
    assert got["window_s"] == pytest.approx(80e-6)
    gaps = dict(got["idle_gaps"])
    assert gaps["step > aten::nonzero"] == pytest.approx(17e-6)
    assert gaps["step > Optimizer.step#AdamW.step"] == pytest.approx(10e-6)
    assert got["device_ops"][0] == ["nvjet_tst_gemm", pytest.approx(2e-5)]


def test_complete_holds_the_trace_to_the_ports_counters():
    got = profile.summarize(_trace(), steps=1)
    assert profile.complete(got, {"flash_fwd_sm90": 1,
                                  "flash_bwd_dq_sm90": 1})
    assert not profile.complete(got, {"flash_fwd_sm90": 2})


def test_a_cpu_profile_has_no_device_time():
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).mul_(2.0)
    got = profile.summarize(prof, steps=1)
    assert got["busy_s"] == 0 and got["window_s"] == 0
    assert got["total_kernel_ms"] == 0


@pytest.mark.parametrize("complete_at, takes", [(1, 1), (3, 3), (None, 3)])
def test_a_trace_short_of_the_ports_launches_fails_the_run(
        monkeypatch, complete_at, takes):
    """The traced steps are profiled again while the trace lacks a record
    of a launch the port counted; a third take that still lacks one
    fails the run rather than report shares of a short kernel time."""
    import contextlib

    import torch.profiler

    from benchmark.harness import job

    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext(NS()))
    monkeypatch.setattr(job, "_sync", lambda device: None)
    monkeypatch.setattr(job, "_event",
                        lambda device: NS(elapsed_time=lambda end: 9.0))
    monkeypatch.setattr(profile, "summarize",
                        lambda prof, steps: {"kernel_counts": {}})
    seen = []
    monkeypatch.setattr(profile, "complete",
                        lambda summary, launched:
                        complete_at is not None
                        and len(seen) == 2 * complete_at)
    run = lambda k: seen.append(k)  # noqa: E731
    if complete_at is None:
        with pytest.raises(RuntimeError, match="dropped records"):
            job.profile_steps(run, 10, 2, NS(type="cuda"))
    else:
        got = job.profile_steps(run, 10, 2, NS(type="cuda"))
        assert got["takes"] == takes and got["device_ms"] == 9.0
    assert seen == list(range(10, 10 + 2 * takes))
