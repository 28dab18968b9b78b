"""The traced run's spans: each device record of a ``torch.profiler``
trace put down to the span of the port that launched it, and each idle
gap of the device to the span the host was in when the gap began.

With its spans on (``pytorch_operator_tpu_torch/telemetry/spans.py``)
the port opens a ``ptt.<name>`` range around the work of each layer.
A device record belongs to the host operator that launched it
(``FunctionEvent.kernels``), and its owner is found by walking up from
that operator:

  (a) the nearest ``ptt.*`` range owns it: the forward, and a
      checkpoint's recompute, which opens its spans again;
  (b) else, where the walk passes an ``autograd::engine::
      evaluate_function:`` node, the span around that node's forward
      operator, found by (``sequence_nr``, ``fwd_thread``), or by the
      number alone where that thread ran no forward: the backward,
      custom ``autograd.Function``s included;
  (c) else ``Optimizer.step``'s range: ``optimizer``;
  (d) else ``none``.

Records no host operator claims are ``none`` too, so the owners' times
sum to the trace's kernel total (``profile.summarize``'s
``total_kernel_ms``).  Nothing here imports the program.
"""

from __future__ import annotations

import bisect
from collections import Counter

from benchmark.harness.profile import SCAN, TOP, device_events, kernel_class

PREFIX = "ptt."
BACKWARD = "autograd::engine::evaluate_function: "
OPTIMIZER = "Optimizer.step"
NONE = "none"


def _host(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CPU and not e.is_async]


def _nearest(e, prefix: str):
    while e is not None and not e.name.startswith(prefix):
        e = e.cpu_parent
    return e


def owners(host: list):
    """``owner(event)``: the span that owns the work ``event`` (a host
    operator) launched, by rules (a)-(d) above."""
    # the forward operator of each backward node: of the operators that
    # took its sequence number on its thread outside the backward, the
    # last to start (an operator that creates no node, such as a no-op
    # cast, takes the number the next node gets); by the number alone
    # where the node's forward thread is not among them
    forward, by_number = {}, {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and _nearest(e, BACKWARD) is None:
            forward[(e.sequence_nr, e.thread)] = e
            by_number[e.sequence_nr] = e
    memo = {}

    def owner(e) -> str:
        key = id(e)
        if key not in memo:
            memo[key] = _owner(e)
        return memo[key]

    def _owner(e) -> str:
        span = _nearest(e, PREFIX)
        if span is not None:
            return span.name[len(PREFIX):]
        node = _nearest(e, BACKWARD)
        if node is not None:
            fwd = forward.get((node.sequence_nr, node.fwd_thread),
                              by_number.get(node.sequence_nr))
            span = fwd and _nearest(fwd, PREFIX)
            if span is not None:
                return span.name[len(PREFIX):]
        if _nearest(e, OPTIMIZER) is not None:
            return "optimizer"
        return NONE

    return owner


def _label(e) -> str:
    top = e
    while top.cpu_parent is not None:
        top = top.cpu_parent
    return (e.name if top is e else f"{top.name} > {e.name}")[:120]


def _top(by: dict) -> list:
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(prof) -> dict:
    """``span_ms``: {owner: {kernel class: device ms}} over the whole
    trace; ``span_idle_ms``: {owner: ms} of the device's idle gaps, each
    put down to the owner of the innermost host operator running when
    the gap began (``none`` where none runs); ``unowned_ops``: [label,
    ms] of the host operators whose kernels no span owns, their
    outermost range first, longest first; ``doubled``: the same of the
    claims dropped because another event had claimed the record.

    The profiler hands a device record to every host event whose id is
    the record's launching operator's; a host event of the CUDA API that
    is no operator (``Command Buffer Full``) can carry such an id too,
    from another counter.  So each record is claimed once, operators and
    ranges first, and a claim with no record left of its name and length
    is dropped."""
    dev = device_events(prof)
    host = _host(prof)
    owner = owners(host)
    left = Counter((e.name, e.time_range.end - e.time_range.start)
                   for e in dev)
    claims = sorted(((e, k) for e in host for k in e.kernels),
                    key=lambda c: not _is_operator(c[0]))
    span_ms: dict[str, dict[str, float]] = {}
    unowned: dict[str, float] = {}
    doubled: dict[str, float] = {}
    for e, k in claims:
        key, ms = (k.name, k.duration), k.duration / 1e3
        if left[key] <= 0:
            # a range's own copy on the device, or a second claim
            if k.name != e.name:
                doubled[_label(e)] = doubled.get(_label(e), 0.0) + ms
            continue
        left[key] -= 1
        who = owner(e)
        by = span_ms.setdefault(who, {})
        cls = kernel_class(k.name)
        by[cls] = by.get(cls, 0.0) + ms
        if who == NONE:
            unowned[_label(e)] = unowned.get(_label(e), 0.0) + ms
    for (name, us), n in left.items():
        if n > 0:
            by = span_ms.setdefault(NONE, {})
            cls = kernel_class(name)
            by[cls] = by.get(cls, 0.0) + n * us / 1e3
    return {"span_ms": span_ms,
            "span_idle_ms": _idle_by_owner(dev, host, owner),
            "unowned_ops": _top(unowned), "doubled": _top(doubled)}


def _is_operator(e) -> bool:
    """A host event the profiler's op or range records made (an
    ``aten::``, ``ptt::`` or ``c10d::`` operator, a range, an autograd
    node or ``Function``), not one of the CUDA API's."""
    return "::" in e.name or e.is_user_annotation or e.sequence_nr >= 0


def _idle_by_owner(dev: list, host: list, owner) -> dict[str, float]:
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    gaps = []
    if spans:
        cur_e = spans[0][1]
        for start, end in spans[1:]:
            if start > cur_e:
                gaps.append((start - cur_e, cur_e))
            cur_e = max(cur_e, end)
    running = sorted((e for e in host
                      if e.time_range.end > e.time_range.start),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in running]
    out: dict[str, float] = {}
    for length, at in gaps:
        i = bisect.bisect_right(starts, at)
        # the latest-starting operator still running is the innermost
        inner = next((e for e in reversed(running[max(0, i - SCAN):i])
                      if e.time_range.end >= at), None)
        who = NONE if inner is None else owner(inner)
        out[who] = out.get(who, 0.0) + length / 1e3
    return out


def expert_tokens(counts: list) -> list[list[float]]:
    """The ``expert_tokens`` counter's readings (``spans.take_counts()``
    of the port), one list of per-expert token counts a call."""
    return [t.tolist() for name, t in counts if name == "expert_tokens"]


def ms_per_step(run: dict, owner: str) -> float | None:
    """Rank 0's device ms a step of the kernels ``owner`` owns, every
    class; None without a card or where the trace has no such span."""
    t = run["trace"]
    by = t and t.get("span_ms", {}).get(owner)
    if run["platform"] != "gpu" or not by:
        return None
    return sum(by.values()) / t["steps"]
