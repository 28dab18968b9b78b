"""The port's push client against the JAX package's gateway, on the CPU.

``pytorch_operator_tpu_torch/telemetry/push.py`` is the trainer side of
``pytorch_operator_tpu/telemetry/push.py``: the same family names, token
and samples.  Its ``PushClient`` posts to the JAX package's
``PushGateway`` (the operator's, served by its metrics server) and the
families land as the JAX client lands them; a dead operator counts an
error and raises nothing; the port's ``with_step_profiler`` feeds it
through ``on_record``.
"""

import pytest

from pytorch_operator_tpu.metrics.prometheus import Registry
from pytorch_operator_tpu.metrics.server import start_metrics_server
from pytorch_operator_tpu.telemetry import push as jpush
from pytorch_operator_tpu.telemetry.step_timer import StepRecord as JRecord
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import with_step_profiler
from pytorch_operator_tpu_torch.telemetry import push
from pytorch_operator_tpu_torch.telemetry.step_timer import StepRecord

RECORDS = [
    dict(job="j", step=1, step_time_s=3.0, compile=True,
         tokens_per_sec=None, mfu=None),
    dict(job="j", step=2, step_time_s=0.5, compile=False,
         tokens_per_sec=2048.0, mfu=0.4, loss=1.5),
    dict(job="j", step=3, step_time_s=0.25, compile=False,
         tokens_per_sec=None, mfu=None),
    dict(job="j", step=4, step_time_s=0.125, compile=False,
         tokens_per_sec=10.0, mfu=None, loss=None),
]


def test_family_names_are_the_gateways():
    for name in ("STEP_DURATION", "TOKENS_PER_SEC", "MFU", "STEPS_TOTAL",
                 "COMPILE_TIME", "LOSS"):
        assert getattr(push, name) == getattr(jpush, name)
    assert {getattr(push, n) for n in ("STEP_DURATION", "TOKENS_PER_SEC",
                                       "MFU", "STEPS_TOTAL", "COMPILE_TIME",
                                       "LOSS")} == set(jpush._FAMILIES)


@pytest.mark.parametrize("fields", RECORDS)
def test_step_record_samples_equal_jax(fields):
    assert push.step_record_samples(StepRecord(**fields)) == \
        jpush.step_record_samples(JRecord(**fields))


@pytest.mark.parametrize("job,uid,secret", [
    ("default/train-1", "0f3c", ""), ("ns/x", "uid-2", "s3cret"),
    ("a/b", "", "k" * 80)])
def test_derive_push_token_equals_jax(job, uid, secret):
    assert push.derive_push_token(job, uid, secret) == \
        jpush.derive_push_token(job, uid, secret)


@pytest.fixture()
def gateway():
    """The JAX package's PushGateway behind its metrics server."""
    registry = Registry()
    server = start_metrics_server(registry, 0, host="127.0.0.1",
                                  push_gateway=jpush.PushGateway(registry))
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", registry
    finally:
        server.shutdown()


def test_client_lands_the_families_the_jax_client_lands(gateway):
    url, registry = gateway
    mine = push.PushClient(url, "default/port")
    theirs = jpush.PushClient(url, "default/jax")
    for fields in RECORDS:
        mine.on_record(StepRecord(**fields))
        theirs.on_record(JRecord(**fields))
    out = push.push_job_steps(url, "default/port", [0.1, 0.2],
                              tokens_per_sec=5.0, mfu=0.3)
    want = jpush.push_job_steps(url, "default/jax", [0.1, 0.2],
                                tokens_per_sec=5.0, mfu=0.3)
    assert out == want and out["accepted"] == 6 and out["rejected"] == 0
    assert mine.errors == 0 and mine.pushed == theirs.pushed == 11
    text = registry.expose()
    port_lines = sorted(ln.replace("default/port", "J") for ln in
                        text.splitlines() if 'job="default/port"' in ln)
    jax_lines = sorted(ln.replace("default/jax", "J") for ln in
                       text.splitlines() if 'job="default/jax"' in ln)
    assert port_lines == jax_lines and len(port_lines) > 10
    assert 'pytorch_operator_job_loss{job="default/port"} 1.5' in text
    assert 'pytorch_operator_job_steps_total{job="default/port"} 5' in text


def test_token_is_carried(gateway):
    url, registry = gateway
    token = push.derive_push_token("default/t", "uid")
    client = push.PushClient(url, "default/t", token=token)
    assert client.push_samples([{"name": push.LOSS, "op": "set",
                                 "value": 2.0}])["accepted"] == 1


def test_dead_operator_counts_an_error_and_raises_nothing():
    client = push.PushClient("http://127.0.0.1:1", "default/j", timeout=0.2)
    assert client.push_samples([{"name": push.STEP_DURATION,
                                 "op": "observe", "value": 1.0}]) is None
    client.on_record(StepRecord(**RECORDS[1]))
    assert client.errors == 2 and client.pushed == 0
    assert push.push_job_steps("http://127.0.0.1:1", "default/j", [0.1],
                               timeout=0.2) is None


def test_on_record_through_with_step_profiler(gateway):
    url, registry = gateway
    client = push.PushClient(url, "default/llama")
    cfg = llama.tiny(n_layers=1)

    def step(state, batch):
        return state, {"loss": 2.5}

    profiled, profiler = with_step_profiler(
        step, cfg, batch=2, seq_len=8, device="cpu", job="default/llama",
        on_record=client.on_record)
    for _ in range(3):
        profiled(None, None)
    assert profiler.step_count == 3 and client.errors == 0
    text = registry.expose()
    for line in (
            'pytorch_operator_job_compile_time_seconds{job="default/llama"}',
            'pytorch_operator_job_step_duration_seconds_count'
            '{job="default/llama"} 2',
            'pytorch_operator_job_steps_total{job="default/llama"} 2',
            'pytorch_operator_job_loss{job="default/llama"} 2.5',
            'pytorch_operator_job_tokens_per_second{job="default/llama"}',
            'pytorch_operator_job_mfu{job="default/llama"}'):
        assert line in text, line
