"""The port's spans and counters (``telemetry/spans.py``) on the CPU.

Off, the port makes no profiler call and a profile holds none of its
ranges; on, each layer's span is in the trace, a checkpoint's recompute
opens its spans again, and no loss or gradient changes by a bit; the
``expert_tokens`` counter holds each MoE layer's routed-token counts.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_operator_tpu_torch.models import llama, moe, resnet
from pytorch_operator_tpu_torch.parallel import train
from pytorch_operator_tpu_torch.telemetry import spans
from pytorch_operator_tpu_torch.telemetry.trace import StepTrace

T = 16
NAMES = {"norm", "attention", "ffn", "head_ce", "global_norm"}


def _model(kind: str, **kw):
    if kind == "moe":
        cfg = moe.tiny(**kw)
        return cfg, moe.MoELlama(cfg, device="cpu")
    cfg = llama.tiny(**kw)
    return cfg, llama.Llama(cfg, device="cpu")


def _batch(cfg, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (2, T + 1), generator=g)


def _step(kind: str, chunked_ce: bool = False, **kw):
    cfg, model = _model(kind, **kw)
    opt = train.adamw(model)
    step = train.make_train_step(cfg, model, opt, chunked_ce=chunked_ce,
                                 ce_chunk=T // 2)
    state = train.TrainState(model, opt)
    return cfg, lambda batch: step(state, batch)


def _ranges(prof) -> dict:
    out = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            name = e.name[len(spans.PREFIX):]
            out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("kind", ["llama", "moe"])
def test_spans_off_make_no_profiler_call(kind, monkeypatch):
    """Off, the port's step opens no range (torch's optimizer opens its
    own, always) and a profile of it holds none of the port's."""
    enter = torch.ops.profiler._record_function_enter_new
    opened = []

    def guarded(name, args=None):
        if not name.startswith("Optimizer."):
            raise AssertionError(f"a profiler range opened with spans "
                                 f"off: {name}")
        opened.append(name)
        return enter(name, args)

    cfg, step = _step(kind)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        guarded)
    step(_batch(cfg))
    assert opened  # the patch is the one record_function calls
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_batch(cfg, 1))
    assert _ranges(prof) == {}


def test_a_span_off_is_one_shared_object():
    assert spans.span("norm") is spans.span("ffn")
    with spans.enabled():
        assert spans.span("norm") is not spans.span("norm")
        with spans.enabled(False):
            assert spans.span("norm") is spans.span("ffn")
        assert spans.span("norm") is not spans.span("norm")
    assert spans.span("norm") is spans.span("ffn")


def test_counts_are_kept_only_while_on_and_taken_once():
    spans.take_counts()
    spans.count("x", torch.ones(2))
    assert spans.take_counts() == []
    with spans.enabled():
        spans.count("x", torch.ones(2, requires_grad=True))
    got = spans.take_counts()
    assert [n for n, _ in got] == ["x"] and not got[0][1].requires_grad
    assert spans.take_counts() == []


@pytest.mark.parametrize("kind,chunked_ce", [("llama", False),
                                             ("llama", True),
                                             ("moe", False)])
def test_spans_on_name_every_layer(kind, chunked_ce):
    cfg, step = _step(kind, chunked_ce)
    with spans.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_batch(cfg))
    got = _ranges(prof)
    L = cfg.n_layers
    assert set(got) == NAMES
    assert got["attention"] == got["ffn"] == L
    assert got["norm"] == 2 * L + 1
    assert got["global_norm"] == 1
    # the tied head and the CE; chunked, each chunk's function again in
    # its recompute
    assert got["head_ce"] == (1 + 2 * 2 if chunked_ce else 2)


@pytest.mark.parametrize("kind,policy", [("llama", None),
                                         ("llama", "dots_saveable"),
                                         ("llama", "save_attn+normed+qkv"),
                                         ("moe", None)])
def test_a_recompute_carries_its_spans(kind, policy):
    """Every checkpointed layer's spans open again in its recompute,
    the norms too where the policy keeps their outputs."""
    kw = dict(remat=True, remat_policy=policy,
              use_flash=policy is not None and "save_attn" in policy)
    cfg, step = _step(kind, **kw)
    with spans.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_batch(cfg))
    got = _ranges(prof)
    L = cfg.n_layers
    assert got["attention"] == got["ffn"] == 2 * L
    assert got["norm"] == 2 * 2 * L + 1


def _loss_and_grads(kind, kw, on: bool):
    cfg, model = _model(kind, **kw)
    batch = _batch(cfg)

    def loss_fn():
        inputs, targets = batch[:, :-1], batch[:, 1:]
        out = model(inputs)
        if kind == "moe":
            out, aux = out
            return (train.tied_ce(model, out, targets)
                    + moe.AUX_LOSS_WEIGHT * aux)
        return train.tied_ce(model, out, targets)

    if on:
        with spans.enabled(), profile(activities=[ProfilerActivity.CPU]):
            loss = loss_fn()
            loss.backward()
        spans.take_counts()
    else:
        loss = loss_fn()
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind,kw", [
    ("llama", {}),
    ("moe", {}),
    ("llama", dict(remat=True, remat_policy="save_attn+normed",
                   use_flash=True)),
    ("llama", dict(remat=True, remat_policy="dots_saveable"))],
    ids=["llama", "moe", "llama-save_attn+normed", "llama-dots_saveable"])
def test_spans_change_no_bit(kind, kw):
    loss_off, grads_off = _loss_and_grads(kind, kw, False)
    loss_on, grads_on = _loss_and_grads(kind, kw, True)
    assert torch.equal(loss_off, loss_on)
    assert grads_off.keys() == grads_on.keys()
    for name, g in grads_off.items():
        assert torch.equal(g, grads_on[name]), name


def test_expert_tokens_count_the_top_k_picks(monkeypatch):
    cfg, model = _model("moe")
    seen = []
    ffn = moe.moe_ffn

    def spy(x, blk):
        probs = torch.softmax((x @ blk.router).float(), dim=-1)
        picks = probs.topk(cfg.top_k, dim=-1).indices
        seen.append(torch.bincount(picks.flatten(), minlength=cfg.n_experts))
        return ffn(x, blk)

    monkeypatch.setattr(moe, "moe_ffn", spy)
    spans.take_counts()
    with spans.enabled(), torch.no_grad():
        model(_batch(cfg)[:, :-1])
    got = spans.take_counts()
    assert [n for n, _ in got] == ["expert_tokens"] * cfg.n_layers
    for (_, counts), want in zip(got, seen):
        assert torch.equal(counts, want.float())
        assert counts.sum() == 2 * T * cfg.top_k


def test_batch_norm_has_its_span_forward_and_backward():
    model = resnet.resnet18_thin(device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    images = torch.randn(2, 16, 16, 3)  # NHWC, as the JAX model takes
    with spans.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, _ = resnet.apply(model, images, train=True)
        logits.sum().backward()
    bn = [e for e in prof.events() if e.name == "ptt.batch_norm"]
    n = sum(isinstance(m, resnet.FlaxBatchNorm) for m in model.modules())
    assert len(bn) == 2 * n  # each forward and its backward
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        resnet.apply(model, images, train=True)
    assert _ranges(prof) == {}


def test_step_trace_carries_the_spans_of_its_window(tmp_path):
    cfg, step = _step("llama")
    trace = StepTrace(str(tmp_path), steps=1, start=0,
                      device=torch.device("cpu"), rank=0)
    for i in range(3):
        trace.before(i)
        assert (spans.span("norm") is not spans.span("norm")) == (i == 1)
        step(_batch(cfg, i))
        trace.after(i)
    assert spans.span("norm") is spans.span("ffn")
    with open(tmp_path / "trace_rank0.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {spans.PREFIX + n for n in NAMES} <= names
