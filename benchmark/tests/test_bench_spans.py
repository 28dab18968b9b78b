"""The spans' reduction (``harness/spans.py``) on real CPU profiles with
device records from a stand-in: forward, backward and recompute work
goes to the span of its forward operator, the optimizer's to its range,
the rest to ``none``, and the owners sum to the kernel total with no
record counted twice."""

from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

import tiny_cells  # noqa: F401  (puts the checkout on the path)
from benchmark.harness import profile as prof_mod
from benchmark.harness import spans
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel import train
from pytorch_operator_tpu_torch.telemetry import spans as port_spans
from pytorch_operator_tpu_torch.telemetry.spans import span

US = 1.0  # each stand-in kernel's length
# operators that launch no kernel on a card: views, detaches,
# allocations, a cast to the same dtype
NO_KERNEL = {f"aten::{n}" for n in (
    "detach", "view", "_unsafe_view", "reshape", "_reshape_alias",
    "expand", "t", "transpose", "permute", "unsqueeze", "squeeze",
    "slice", "select", "as_strided", "alias", "split", "chunk", "narrow",
    "unbind", "lift_fresh", "empty", "empty_like", "empty_strided",
    "resolve_conj", "resolve_neg", "to")}


def _launches(e) -> bool:
    return (e.name.startswith("aten::") and e.name not in NO_KERNEL
            and all(c.name in NO_KERNEL for c in e.cpu_children))


class StandIn:
    """A CPU profile with one stand-in kernel for each innermost
    ``aten::`` operator that would launch one on a card (at its start,
    ``US`` long, in its ``kernels``), a record no operator launched and
    the device copy of a range."""

    def __init__(self, prof):
        self.host = [e for e in prof.events()
                     if e.device_type == DeviceType.CPU]
        self.launched = []
        dev = []
        for e in self.host:
            if _launches(e):
                name = f"k{len(dev)} {e.name}"
                e.kernels.append(NS(name=name, duration=US))
                self.launched.append(e)
                dev.append(_dev(name, e.time_range.start))
        end = max(e.time_range.end for e in self.host)
        dev.append(_dev("stray_memcpy", end + 10))
        ranges = [e for e in self.host if e.name.startswith("ptt.")]
        if ranges:
            first = ranges[0]
            first.kernels.append(NS(name=first.name, duration=5 * US))
            dev.append(_dev(first.name, first.time_range.start,
                            annotation=True))
        self.dev = dev

    def events(self):
        return self.host + self.dev


def _dev(name, start, annotation=False):
    return NS(name=name, device_type=DeviceType.CUDA,
              is_user_annotation=annotation, is_async=False,
              time_range=NS(start=start, end=start + US))


def _expected(e, by_node: dict, by_op: dict) -> str:
    """The owner read off names alone: the backward node's kind, or the
    forward operator's, or the optimizer's range."""
    node = e
    while node is not None:
        if node.name.startswith(spans.BACKWARD):
            return by_node.get(node.name[len(spans.BACKWARD):], "none")
        if node.name.startswith("Optimizer.step"):
            return "optimizer"
        node = node.cpu_parent
    return by_op.get(e.name, "none")


def _owned(got) -> float:
    return sum(sum(by.values()) for by in got["span_ms"].values())


def _c(t):
    with span("c"):
        return torch.tanh(t)


def test_every_record_goes_to_the_span_of_its_forward_operator():
    x = torch.randn(64, requires_grad=True)
    opt = torch.optim.SGD([x], lr=0.1)
    with port_spans.enabled(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with span("a"):
            # a no-op cast creates no node and takes the number of the
            # next node, exp's
            y = torch.sin(x).float()
        with span("b"):
            z = torch.exp(y)
        w = checkpoint(_c, z, use_reentrant=False)
        w.sum().backward()
        opt.step()
    standin = StandIn(prof)
    got = spans.reduce(standin)
    owner = spans.owners(standin.host)
    by_node = {"SinBackward0": "a", "ExpBackward0": "b",
               "TanhBackward0": "c"}
    by_op = {"aten::sin": "a", "aten::exp": "b", "aten::tanh": "c"}
    for e in standin.launched:
        assert owner(e) == _expected(e, by_node, by_op), e.name
    # the recompute's tanh carries its own span, inside the backward
    tanhs = [e for e in standin.launched if e.name == "aten::tanh"]
    assert len(tanhs) == 2 and {owner(e) for e in tanhs} == {"c"}
    assert set(got["span_ms"]) == {"a", "b", "c", "optimizer", "none"}
    # each record once: the launched ones, the stray one, not the range
    assert _owned(got) == pytest.approx(
        (len(standin.launched) + 1) * US / 1e3)
    summary = prof_mod.summarize(standin, steps=1)
    assert _owned(got) == pytest.approx(summary["total_kernel_ms"])
    assert sum(got["span_idle_ms"].values()) == pytest.approx(
        (summary["window_s"] - summary["busy_s"]) * 1e3)
    assert got["doubled"] == []


def test_a_second_claim_on_a_record_is_dropped():
    """A host event of the runtime that is no operator (the profiler
    gives it the kernels of the operator whose id it shares), inside the
    optimizer's range: the record stays with its operator."""
    x = torch.randn(64, requires_grad=True)
    opt = torch.optim.SGD([x], lr=0.1)
    with port_spans.enabled(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with span("a"):
            y = torch.sin(x)
        y.sum().backward()
        opt.step()
    standin = StandIn(prof)
    want = spans.reduce(standin)
    sin = next(e for e in standin.launched if e.name == "aten::sin")
    step = next(e for e in standin.host
                if e.name.startswith("Optimizer.step"))
    # claims made before the operator's, as the profiler may list them
    standin.host.insert(0, NS(
        name="Command Buffer Full", device_type=DeviceType.CPU,
        is_async=False, is_user_annotation=False, sequence_nr=-1,
        thread=sin.thread, fwd_thread=0, cpu_parent=step,
        time_range=step.time_range, kernels=list(sin.kernels)))
    got = spans.reduce(standin)
    assert got["span_ms"] == want["span_ms"]
    assert got["doubled"] == [[f"{step.name} > Command Buffer Full",
                               pytest.approx(US / 1e3)]]


def test_the_ports_step_with_remat_and_chunked_ce():
    """A tiny Llama step, every layer recomputed, the CE chunked: the
    backward of each layer's work goes to that layer's span."""
    cfg = llama.tiny(remat=True)
    model = llama.Llama(cfg, device="cpu")
    opt = train.adamw(model)
    step = train.make_train_step(cfg, model, opt, chunked_ce=True,
                                 ce_chunk=8)
    state = train.TrainState(model, opt)
    batch = torch.randint(0, cfg.vocab_size, (2, 17),
                          generator=torch.Generator().manual_seed(0))
    with port_spans.enabled(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    standin = StandIn(prof)
    got = spans.reduce(standin)
    owner = spans.owners(standin.host)
    by_node = {"SiluBackward0": "ffn", "RsqrtBackward0": "norm",
               "LogSoftmaxBackward0": "head_ce",
               "GatherBackward0": "head_ce",
               "SoftmaxBackward0": "attention",
               "CatBackward0": "attention"}
    for e in standin.launched:
        node = spans._nearest(e, spans.BACKWARD)
        kind = node and node.name[len(spans.BACKWARD):]
        if kind in by_node:
            assert owner(e) == by_node[kind], (kind, e.name)
    assert {"attention", "ffn", "norm", "head_ce", "global_norm",
            "optimizer"} <= set(got["span_ms"])
    assert _owned(got) == pytest.approx(
        prof_mod.summarize(standin, steps=1)["total_kernel_ms"])
    # what no span owns: the embedding's lookup and its gradient, the
    # loss's division and the gradients' accumulation
    assert got["span_ms"]["none"]["other"] < 0.1 * _owned(got)


def test_a_trace_without_spans_is_all_none_and_optimizer():
    x = torch.randn(8, requires_grad=True)
    opt = torch.optim.SGD([x], lr=0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.sin(x).sum().backward()
        opt.step()
    got = spans.reduce(StandIn(prof))
    assert set(got["span_ms"]) == {"optimizer", "none"}


def test_readers_take_the_spans_a_step():
    from benchmark.harness import spec

    trace = {"steps": 2, "span_ms": {"attention": {"matmul": 6.0,
                                                   "attn_fwd": 2.0}},
             "expert_tokens": [[4.0, 2.0, 1.0, 1.0], [2.0, 2.0, 2.0, 2.0]]}
    run = {"platform": "gpu", "trace": trace}
    read = {n: spec.reader(n, tiny_cells.ROOT / "benchmark")
            for n in ("attention_ms", "ffn_ms", "expert_load_max_ratio")}
    assert read["attention_ms"](run) == pytest.approx(4.0)
    assert read["ffn_ms"](run) is None
    assert read["expert_load_max_ratio"](run) == pytest.approx(1.5)
    # a trace from a program without spans, or no card: nothing to read
    for r in ({"platform": "gpu", "trace": {"steps": 2}},
              {"platform": "cpu", "trace": trace},
              {"platform": "gpu", "trace": None}):
        assert all(f(r) is None for f in read.values())
