"""The traced run's reduction: a ``torch.profiler`` trace of a few steady
steps turned into the numbers the per-layer readers take.

``device_events`` and the kernel classes are frozen copies of
``chip_smoke.py``'s (``device_events``, ``KERNEL_CLASSES``); nothing here
imports the program.  Kernels are attributed to the host operator that
launched them (``FunctionEvent.kernels``): the experts' products are the
kernels ``aten::bmm`` launches, forward and backward, and the optimizer's
are those that run inside the ``Optimizer.step`` range on the device.
"""

from __future__ import annotations

import bisect

import torch

# a device record's class is the first whose key is in its name
KERNEL_CLASSES = (("rms_norm", ("rms_norm_sm90_kernel",
                                "rms_norm_rowblock_kernel")),
                  ("attn_fwd", ("flash_fwd",)),
                  ("attn_bwd", ("flash_bwd",)),
                  ("nccl", ("nccl",)),
                  ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))
# the port's kernels by the class their launch counter falls in
# (kernels.launch_counts()), to see that a profile kept every record
COUNTED_CLASSES = {"flash_fwd_sm90": "attn_fwd", "flash_bwd_sm90": "attn_bwd",
                   "flash_bwd_dq_sm90": "attn_bwd",
                   "flash_bwd_dkv_sm90": "attn_bwd",
                   "flash_fwd": "attn_fwd", "flash_bwd": "attn_bwd",
                   "flash_bwd_dq": "attn_bwd", "flash_bwd_dkv": "attn_bwd",
                   "rms_norm_fwd": "rms_norm",
                   "rms_norm_rowblock_fwd": "rms_norm"}
TOP = 10
LABELLED_GAPS = 500   # the longest gaps, labelled by the host's operator
SCAN = 4000           # host records looked back over for each gap


def kernel_class(name: str) -> str:
    return next((c for c, keys in KERNEL_CLASSES
                 if any(k in name for k in keys)), "other")


def device_events(prof) -> list:
    """The profiler's kernels and copies, one record each.  A
    record_function range also shows on the device and would count its
    kernels twice, so ranges are left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def _label_gaps(gaps: list, host: list) -> list:
    """[label, seconds] of the device's idle gaps, summed by what the host
    was doing when each began: the innermost host operator running then
    (its outermost range first), longest first."""
    host = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by_label: dict[str, float] = {}
    for length, at in gaps:
        i = bisect.bisect_right(starts, at)
        # the latest-starting operator still running is the innermost
        inner = next((e for e in reversed(host[max(0, i - SCAN):i])
                      if e.time_range.end >= at), None)
        if inner is None:
            label = "host idle"
        else:
            top = inner
            while top.cpu_parent is not None:
                top = top.cpu_parent
            label = inner.name if top is inner else f"{top.name} > {inner.name}"
        by_label[label[:120]] = by_label.get(label[:120], 0.0) + length / 1e6
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def summarize(prof, steps: int) -> dict:
    """What the readers take from a trace of ``steps`` steps on one rank:
    device time by kernel class, by launching operator and in total, the
    device's busy and spanned seconds, the operations that took most time
    and the longest idle gaps by what the host was doing."""
    from torch.autograd import DeviceType

    dev = device_events(prof)
    by_class: dict[str, float] = {}
    counts: dict[str, int] = {}
    by_name: dict[str, float] = {}
    spans = []
    for e in dev:
        start, end = e.time_range.start, e.time_range.end
        ms = (end - start) / 1e3
        cls = kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        counts[cls] = counts.get(cls, 0) + 1
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        spans.append((start, end))
    events = prof.events()
    # the optimizer's kernels: those inside its range on the device
    # (a record_function range also shows on the device as an annotation)
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and e.is_user_annotation
              and e.name.startswith("Optimizer.step")]
    optimizer_ms = sum((end - start) / 1e3 for start, end in spans
                       if any(a <= start and end <= b for a, b in ranges))
    # the kernels each host operator launched (the experts' products are
    # aten::bmm's)
    bmm_ms = sum(sum(k.duration for k in e.kernels) / 1e3 for e in events
                 if e.device_type == DeviceType.CPU and e.name == "aten::bmm")
    spans.sort()
    busy_us, gaps = 0.0, []
    if spans:
        cur_s, cur_e = spans[0][0], spans[0][1]
        for start, end in spans[1:]:
            if start > cur_e:
                busy_us += cur_e - cur_s
                gaps.append((start - cur_e, cur_e))
                cur_s, cur_e = start, end
            else:
                cur_e = max(cur_e, end)
        busy_us += cur_e - cur_s
        window_us = max(s[1] for s in spans) - spans[0][0]
    else:
        window_us = 0.0
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.is_async and e.time_range.end > e.time_range.start]
    idle = _label_gaps(sorted(gaps, reverse=True)[:LABELLED_GAPS], host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"steps": steps,
            "kernel_ms": by_class, "kernel_counts": counts,
            "total_kernel_ms": sum(by_class.values()),
            "optimizer_ms": optimizer_ms, "bmm_ms": bmm_ms,
            "busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
            "device_ops": [[name[:120], ms / 1e3] for name, ms in top],
            "idle_gaps": idle}


def complete(summary: dict, launches: dict[str, int]) -> bool:
    """Whether the trace holds a record of every launch the port counted
    (``launches``: its counters' growth over the traced steps): the
    profiler has dropped records of long kernels now and then."""
    want: dict[str, int] = {}
    for symbol, n in launches.items():
        cls = COUNTED_CLASSES.get(symbol)
        if cls is not None and n:
            want[cls] = want.get(cls, 0) + n
    return all(summary["kernel_counts"].get(c, 0) >= n
               for c, n in want.items())


def warm_profiler(tries: int = 5) -> bool:
    """Profiles of a small kernel until one records device time, up to
    ``tries``: a process's first profiler sessions have come back without
    device records (a frozen copy of ``chip_smoke.warm_profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                x.mul_(1.0)
            torch.cuda.synchronize()
        if device_events(prof):
            return True
    return False
