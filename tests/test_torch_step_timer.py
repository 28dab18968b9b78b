"""The port's step profiler against the JAX package's.

The cases of ``tests/test_telemetry.py`` that apply to the profiler,
run on both classes with a fake clock: the same records, JSON lines
byte for byte, the same ``read_step_log`` dict.  Then the H100 row of
the peak table, and ``with_step_profiler`` on the port's tiny step.
"""

import itertools
import json
import warnings

import numpy as np
import pytest
import torch

from pytorch_operator_tpu.telemetry import step_timer as jst
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel import train
from pytorch_operator_tpu_torch.telemetry import step_timer as tst

BOTH = pytest.mark.parametrize("mod", [jst, tst], ids=["jax", "port"])


def fake_clock(*times):
    it = iter(times)
    return lambda: next(it)


@pytest.mark.parametrize("fields", [
    dict(job="default/j", step=1, step_time_s=3.0, compile=True,
         tokens_per_sec=None, mfu=None),
    dict(job="", step=7, step_time_s=0.123456, compile=False,
         tokens_per_sec=2048.5, mfu=0.412345, loss=2.25),
    dict(job="ns/x", step=2, step_time_s=1e-06, compile=False,
         tokens_per_sec=None, mfu=None, loss=0.0),
])
def test_step_record_json_is_byte_equal(fields):
    assert tst.StepRecord(**fields).to_json() == jst.StepRecord(
        **fields).to_json()


@BOTH
def test_compile_vs_steady_split(mod):
    prof = mod.StepProfiler(job="default/j", batch=4, seq_len=256,
                            n_params=1000, peak_flops=1e12)
    first = prof.observe(3.0)
    assert first.compile and prof.compile_time_s == 3.0
    assert first.tokens_per_sec is None
    prof.observe(0.5)
    prof.observe(0.5)
    assert prof.mean_step_time() == pytest.approx(0.5)
    assert prof.compile_time_s == 3.0


@BOTH
def test_tokens_per_sec_and_mfu_math(mod):
    prof = mod.StepProfiler(batch=4, seq_len=256, n_params=int(1e9),
                            n_chips=2, peak_flops=1e12)
    prof.observe(1.0)
    rec = prof.observe(0.5)
    assert rec.tokens_per_sec == pytest.approx(2048.0)
    expected_mfu = (6 * 1e9 * 1024 / 0.5) / (1e12 * 2)
    assert rec.mfu == pytest.approx(expected_mfu, rel=1e-4)
    assert prof.tokens_per_sec() == pytest.approx(2048.0)
    assert prof.mfu() == pytest.approx(expected_mfu, rel=1e-4)


@BOTH
def test_no_model_shape_means_no_throughput(mod):
    prof = mod.StepProfiler()
    prof.observe(1.0)
    rec = prof.observe(0.1)
    assert rec.tokens_per_sec is None and rec.mfu is None


@BOTH
def test_rolling_window(mod):
    prof = mod.StepProfiler(batch=1, seq_len=1, window=2)
    prof.observe(9.0)
    for t in (1.0, 2.0, 4.0):
        prof.observe(t)
    assert prof.mean_step_time() == pytest.approx(3.0)


@BOTH
def test_on_record_exceptions_never_escape(mod):
    def boom(record):
        raise RuntimeError("push failed")

    mod.StepProfiler(on_record=boom).observe(1.0)


def _log(mod, path, times, losses):
    prof = mod.StepProfiler(job="default/j", batch=2, seq_len=8,
                            n_params=100, peak_flops=1e12,
                            jsonl_path=str(path))
    for t, loss in zip(times, losses):
        prof.observe(t, loss=loss)
    prof.close()
    return prof


def test_jsonl_log_is_byte_equal_and_reads_back_alike(tmp_path):
    times, losses = (1.0, 0.01, 0.01, 0.02), (2.5, 2.0, 1.5, None)
    jprof = _log(jst, tmp_path / "jax.jsonl", times, losses)
    tprof = _log(tst, tmp_path / "port.jsonl", times, losses)
    text = (tmp_path / "port.jsonl").read_text()
    assert text == (tmp_path / "jax.jsonl").read_text()
    lines = [json.loads(ln) for ln in text.splitlines()]
    assert lines[0]["compile"] is True and lines[1]["loss"] == 2.0
    assert "loss" not in lines[3]
    parsed = tst.read_step_log(str(tmp_path / "port.jsonl"))
    assert parsed == jst.read_step_log(str(tmp_path / "jax.jsonl"))
    assert parsed["unit"] == "tok/s" and parsed["steps"] == 3
    assert tprof.summary() == jprof.summary()


@pytest.mark.parametrize("text", [
    '{"compile": true, "step": 1, "step_time_s": 1.0}\n'
    '{"compile": false, "step": 2, "step_time_s": 0.5}\n',
    '{"compile": true, "step": 1, "step_time_s": 9}\n',
    'not json\n\n{"compile": false, "step": 2, "step_time_s": 0.5, '
    '"tokens_per_sec": 10}\n[1, 2]\n',
], ids=["no-throughput", "compile-only", "junk-lines"])
def test_read_step_log_matches_jax(tmp_path, text):
    path = tmp_path / "steps.jsonl"
    path.write_text(text)
    assert tst.read_step_log(str(path)) == jst.read_step_log(str(path))


def test_wrap_with_a_fake_clock_times_each_call():
    prof = tst.StepProfiler(batch=2, seq_len=8, n_params=100,
                            peak_flops=1e12, device="cpu",
                            clock=fake_clock(0.0, 5.0, 5.0, 5.25, 6.0,
                                             6.5))
    wrapped = prof.wrap(lambda state, batch: (state + 1,
                                              {"loss": torch.tensor(1.25)}))
    assert wrapped.profiler is prof
    state = 0
    for _ in range(3):
        state, _ = wrapped(state, None)
    assert state == 3 and prof.step_count == 3
    assert prof.compile_time_s == 5.0
    assert prof.mean_step_time() == pytest.approx(0.375)
    assert prof.records[-1].loss == pytest.approx(1.25)


def test_peak_table_and_flops():
    """NVIDIA rows only: the H100 SXM and PCIe data-sheet peaks, the
    nominal cpu row; any other kind (a TPU, another card) has no peak,
    with one warning per kind, and never another device's figure."""
    assert tst.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert tst.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    assert tst.peak_flops_per_chip("cpu") == 1e11
    assert not any(k.startswith("tpu") for k in tst.PEAK_FLOPS_PER_CHIP)
    for kind in ("TPU v5p chip", "TPU v4", "NVIDIA A100-SXM4-80GB",
                 "Radeon"):
        with pytest.warns(UserWarning, match="MFU is not reported"):
            assert tst.peak_flops_per_chip(kind) is None
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # once per kind
            assert tst.peak_flops_per_chip(kind) is None
    assert tst.train_step_flops(10, 2, 3) == jst.train_step_flops(10, 2, 3)
    assert tst.device_kind("cpu") == "cpu"


def test_unknown_card_has_no_mfu(monkeypatch):
    """The profiler's summary on a card the table does not know: tokens/s
    as usual, MFU None."""
    monkeypatch.setattr(tst, "device_kind", lambda device: "NVIDIA L4")
    monkeypatch.setattr(tst, "_warned_kinds", set())
    prof = tst.StepProfiler(batch=4, seq_len=256, n_params=int(1e9),
                            device="cpu")
    with pytest.warns(UserWarning, match="NVIDIA L4"):
        for t in (1.0, 0.5, 0.5):
            rec = prof.observe(t)
    assert rec.tokens_per_sec == pytest.approx(2048.0) and rec.mfu is None
    summary = prof.summary()
    assert summary["tokens_per_sec"] == pytest.approx(2048.0)
    assert summary["mfu"] is None and prof.mfu() is None


def test_with_step_profiler_on_the_port_step():
    cfg = llama.tiny(n_layers=1, max_seq_len=16)
    model = llama.Llama(cfg, device="cpu")
    opt = train.adamw(model)
    step = train.make_train_step(cfg, model, opt)
    B, T = 2, 16
    profiled, prof = train.with_step_profiler(
        step, cfg, batch=B, seq_len=T, device="cpu", job="default/train")
    state = train.TrainState(model, opt)
    batches = itertools.cycle([np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T + 1))])
    for _ in range(3):
        state, metrics = profiled(state, next(batches))
    summary = prof.summary()
    assert summary["steps"] == 3 and state.step == 3
    assert summary["tokens_per_sec"] > 0
    assert summary["mfu"] is not None and summary["mfu"] > 0
    assert prof.n_params == llama.n_params(cfg)
    assert prof.peak_flops == tst.PEAK_FLOPS_PER_CHIP["cpu"]
    assert prof.records[-1].loss == pytest.approx(float(metrics["loss"]))
