"""The trainer side of push ingestion: job pods POST per-step samples.

Port of the client half of ``pytorch_operator_tpu/telemetry/push.py``,
as the port's own copy.  A training pod posts ``POST
{base}/push/v1/metrics`` with a JSON body of samples; the operator's
gateway (``PushGateway``, which stays in the JAX package with the rest
of the operator) validates each against a fixed family schema and
re-exports it ``job``-labeled.  The family names, the token derivation
and the sample vocabulary below are the gateway's, byte for byte.

Wire format (one POST, any number of samples)::

    {"job": "default/train-1",
     "token": "...",
     "samples": [
       {"name": "pytorch_operator_job_step_duration_seconds",
        "op": "observe", "value": 0.42},
       {"name": "pytorch_operator_job_tokens_per_second",
        "op": "set", "value": 15234.5}]}

``PushClient.on_record`` plugs into ``StepProfiler(on_record=...)`` (and
so into ``parallel.train.with_step_profiler``).  A failed POST is counted
in ``errors`` and never raised: a dead operator must not fail a step.
"""

from __future__ import annotations

import hashlib
import json
import urllib.request
from typing import Dict, List, Optional

from pytorch_operator_tpu_torch.telemetry.step_timer import StepRecord

STEP_DURATION = "pytorch_operator_job_step_duration_seconds"
TOKENS_PER_SEC = "pytorch_operator_job_tokens_per_second"
MFU = "pytorch_operator_job_mfu"
STEPS_TOTAL = "pytorch_operator_job_steps_total"
COMPILE_TIME = "pytorch_operator_job_compile_time_seconds"
LOSS = "pytorch_operator_job_loss"


def derive_push_token(job: str, uid: str, secret: str = "") -> str:
    """The per-job push token: a keyed blake2b of the job's
    ``namespace/name`` and uid (the operator injects it as
    ``PYTORCH_OPERATOR_PUSH_TOKEN`` and derives it again at ingestion)."""
    h = hashlib.blake2b(digest_size=16,
                        key=secret.encode()[:64] if secret else b"")
    h.update(job.encode())
    h.update(b"\x00")
    h.update(uid.encode())
    return h.hexdigest()


def step_record_samples(record: StepRecord) -> List[dict]:
    """One StepProfiler record as push samples: the first (warm-up) step
    as the compile time, a steady step as its duration, a step count and
    whichever of tokens/s, MFU and loss it carries."""
    if record.compile:
        return [{"name": COMPILE_TIME, "op": "set",
                 "value": record.step_time_s}]
    samples = [
        {"name": STEP_DURATION, "op": "observe",
         "value": record.step_time_s},
        {"name": STEPS_TOTAL, "op": "inc", "value": 1},
    ]
    if record.tokens_per_sec is not None:
        samples.append({"name": TOKENS_PER_SEC, "op": "set",
                        "value": record.tokens_per_sec})
    if record.mfu is not None:
        samples.append({"name": MFU, "op": "set", "value": record.mfu})
    if record.loss is not None:
        samples.append({"name": LOSS, "op": "set", "value": record.loss})
    return samples


class PushClient:
    """Best-effort POSTs to the operator's ``/push/v1/metrics``: a failure
    (refused connection, timeout, an HTTP error status) increments
    ``errors`` and returns None; ``pushed`` counts the samples the
    operator answered for."""

    def __init__(self, base_url: str, job: str, timeout: float = 2.0,
                 token: Optional[str] = None):
        self.url = base_url.rstrip("/") + "/push/v1/metrics"
        self.job = job
        self.timeout = timeout
        self.token = token
        self.errors = 0
        self.pushed = 0

    def push_samples(self, samples: List[dict]) -> Optional[dict]:
        payload = {"job": self.job, "samples": samples}
        if self.token:
            payload["token"] = self.token
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read().decode() or "{}")
        except Exception:  # noqa: BLE001 - telemetry never fails a step
            self.errors += 1
            return None
        self.pushed += len(samples)
        return out

    def on_record(self, record: StepRecord) -> None:
        self.push_samples(step_record_samples(record))


def push_job_steps(base_url: str, job: str,
                   step_times: List[float],
                   tokens_per_sec: Optional[float] = None,
                   mfu: Optional[float] = None,
                   timeout: float = 2.0,
                   token: Optional[str] = None) -> Optional[dict]:
    """One POST of a batch of step durations (and optional throughput
    gauges) for ``job``."""
    samples: List[Dict] = []
    for t in step_times:
        samples.append({"name": STEP_DURATION, "op": "observe", "value": t})
        samples.append({"name": STEPS_TOTAL, "op": "inc", "value": 1})
    if tokens_per_sec is not None:
        samples.append({"name": TOKENS_PER_SEC, "op": "set",
                        "value": tokens_per_sec})
    if mfu is not None:
        samples.append({"name": MFU, "op": "set", "value": mfu})
    return PushClient(base_url, job, timeout=timeout,
                      token=token).push_samples(samples)
