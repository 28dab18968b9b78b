"""StepProfiler: per-step timing, throughput and MFU of a training step.

Port of ``pytorch_operator_tpu/telemetry/step_timer.py``.  It wraps a
``make_train_step`` product without touching it: each call is timed
around ``torch.cuda.synchronize`` on a CUDA device, so the time covers
the device's work and not only the launches (a CPU step is already
synchronous).  The FIRST call is recorded apart as the warm-up
("compile": the kernels' build and load, the allocator's first
allocations); later calls feed a rolling window of steady step times,
from which tokens/s and an MFU estimate follow.

MFU uses the 6·N·B·T decoder approximation (forward 2·N·B·T, backward
4·N·B·T, attention FLOPs left out) against a per-device peak from a
table of NVIDIA data-sheet figures; it is an ESTIMATE, comparable across
runs.  A device the table does not know has no MFU (None), never another
device's peak.

Every step may append one JSON line to a step log; ``read_step_log``
aggregates such a log.  Both are byte-compatible with the JAX module's.
"""

from __future__ import annotations

import json
import threading
import time
import warnings
from collections import deque
from dataclasses import asdict, dataclass
from typing import IO, Any, Callable, Dict, Optional

import torch

#: Peak dense-matmul FLOPs per device (bf16, without sparsity), from
#: NVIDIA's data sheets.  Keys are lowercased device-name prefixes, as
#: ``torch.cuda.get_device_name`` gives them: the H100 SXM reports itself
#: as "NVIDIA H100 80GB HBM3", the PCIe card as "NVIDIA H100 PCIe".
#: ``cpu`` is a nominal figure so that a CPU run gives finite numbers.
PEAK_FLOPS_PER_CHIP: Dict[str, float] = {
    "nvidia h100 80gb hbm3": 989e12,
    "nvidia h100 pcie": 756e12,
    "cpu": 1e11,
}

_warned_kinds: set = set()


def peak_flops_per_chip(device_kind: str) -> Optional[float]:
    """Longest-prefix lookup into the peak table (lowercased).  A kind
    the table does not know gives None, with a warning once per kind:
    an MFU against another device's peak would be a wrong number."""
    kind = (device_kind or "").lower()
    best = ""
    for prefix in PEAK_FLOPS_PER_CHIP:
        if kind.startswith(prefix) and len(prefix) > len(best):
            best = prefix
    if not best:
        if kind not in _warned_kinds:
            _warned_kinds.add(kind)
            warnings.warn(f"no peak FLOP/s for device {device_kind!r}: "
                          f"MFU is not reported", stacklevel=2)
        return None
    return PEAK_FLOPS_PER_CHIP[best]


def device_kind(device: str | torch.device) -> str:
    """``torch.cuda.get_device_name`` for a CUDA device, else "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def train_step_flops(n_params: int, batch: int, seq_len: int) -> float:
    """Analytic FLOPs of one optimizer step: 6·N per trained token
    (2 forward + 4 backward), the PaLM-paper MFU convention."""
    return 6.0 * float(n_params) * float(batch) * float(seq_len)


@dataclass
class StepRecord:
    """One JSONL line of the step log."""

    job: str
    step: int
    step_time_s: float
    compile: bool
    tokens_per_sec: Optional[float]
    mfu: Optional[float]
    loss: Optional[float] = None

    def to_json(self) -> str:
        d = {k: v for k, v in asdict(self).items() if v is not None}
        return json.dumps(d, sort_keys=True)


class StepProfiler:
    """Times a training step and derives throughput and MFU.

    ``wrap(step_fn)`` returns a drop-in replacement for the step (same
    signature, same return) that records a :class:`StepRecord` per
    call.  Records go to the rolling in-memory window, the optional
    JSONL sink and the optional ``on_record`` callback.
    """

    def __init__(
        self,
        *,
        job: str = "",
        n_params: int = 0,
        batch: int = 0,
        seq_len: int = 0,
        n_chips: int = 1,
        peak_flops: Optional[float] = None,
        device: str | torch.device | None = None,
        window: int = 32,
        jsonl_path: Optional[str] = None,
        jsonl_file: Optional[IO[str]] = None,
        on_record: Optional[Callable[[StepRecord], None]] = None,
        loss_key: str = "loss",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.job = job
        self.n_params = int(n_params)
        self.batch = int(batch)
        self.seq_len = int(seq_len)
        self.n_chips = max(1, int(n_chips))
        # the device the wrapped step runs on: cuda waits for the card
        # before the clock stops; also the peak's kind when none is given
        self.device = torch.device("cuda" if device is None else device)
        self._peak_flops = peak_flops
        self._window: deque = deque(maxlen=max(1, int(window)))
        self._jsonl_path = jsonl_path
        self._file: Optional[IO[str]] = jsonl_file
        self._on_record = on_record
        self._loss_key = loss_key
        self._clock = clock
        self._lock = threading.Lock()
        self.step_count = 0
        self.compile_time_s: Optional[float] = None
        # bounded: the JSONL sink is the full archive, this keeps a
        # recent tail for summary()
        self.records: deque = deque(maxlen=max(int(window), 256))

    # -- construction helpers ---------------------------------------------
    @classmethod
    def for_llama(cls, cfg, mesh=None, *, batch: int, seq_len: int,
                  device: str | torch.device | None = None,
                  job: str = "", **kw) -> "StepProfiler":
        """Profiler sized from a LlamaConfig and a ``DeviceMesh`` (or
        one ``device`` when ``mesh`` is None): params from
        ``cfg.n_params()`` (an ``MoEConfig``'s dense dispatch runs them
        all), device count from the mesh, peak FLOPs from the device's
        name."""
        if mesh is not None:
            device = mesh.device_type
            n_chips = mesh.size()
        else:
            n_chips = 1
        device = torch.device("cuda" if device is None else device)
        return cls(job=job, n_params=cfg.n_params(), batch=batch,
                   seq_len=seq_len, n_chips=n_chips, device=device,
                   peak_flops=peak_flops_per_chip(device_kind(device)),
                   **kw)

    # -- derived numbers ---------------------------------------------------
    @property
    def peak_flops(self) -> Optional[float]:
        """The device's peak, None for a device the table does not know."""
        if self._peak_flops is None:
            self._peak_flops = peak_flops_per_chip(device_kind(self.device))
        return self._peak_flops

    def _throughput(self, step_time: float):
        """(tokens/sec, mfu) for one steady-state step; (None, None)
        when the model shape wasn't provided."""
        if step_time <= 0 or not (self.batch and self.seq_len):
            return None, None
        tokens = self.batch * self.seq_len
        tps = tokens / step_time
        mfu = None
        if self.n_params and self.peak_flops:
            achieved = train_step_flops(
                self.n_params, self.batch, self.seq_len) / step_time
            mfu = achieved / (self.peak_flops * self.n_chips)
        return tps, mfu

    def mean_step_time(self) -> Optional[float]:
        """Mean over the rolling window of steady-state steps (the first
        step excluded); None before the second step."""
        with self._lock:
            if not self._window:
                return None
            return sum(self._window) / len(self._window)

    def tokens_per_sec(self) -> Optional[float]:
        mean = self.mean_step_time()
        return self._throughput(mean)[0] if mean else None

    def mfu(self) -> Optional[float]:
        mean = self.mean_step_time()
        return self._throughput(mean)[1] if mean else None

    # -- recording ---------------------------------------------------------
    def observe(self, step_time: float,
                loss: Optional[float] = None) -> StepRecord:
        """Record one already-timed step (wrap() calls this; tests and
        replay tools can call it directly)."""
        with self._lock:
            is_compile = self.compile_time_s is None
            if is_compile:
                # the first call carries the warm-up; steady-state stats
                # must not be polluted by it
                self.compile_time_s = step_time
            else:
                self._window.append(step_time)
            self.step_count += 1
            step = self.step_count
        tps, mfu = (None, None) if is_compile else self._throughput(step_time)
        record = StepRecord(
            job=self.job, step=step, step_time_s=round(step_time, 6),
            compile=is_compile,
            tokens_per_sec=round(tps, 3) if tps is not None else None,
            mfu=round(mfu, 6) if mfu is not None else None,
            loss=loss)
        with self._lock:
            self.records.append(record)
            self._write(record)
        if self._on_record is not None:
            try:
                self._on_record(record)
            except Exception:
                pass  # telemetry must never kill the training loop
        return record

    def _write(self, record: StepRecord) -> None:
        if self._file is None and self._jsonl_path:
            self._file = open(self._jsonl_path, "a")
        if self._file is not None:
            self._file.write(record.to_json() + "\n")
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None and self._jsonl_path:
                self._file.close()
                self._file = None

    # -- the wrapper -------------------------------------------------------
    def wrap(self, step_fn: Callable) -> Callable:
        """Instrument ``step_fn(state, batch, ...)``: identical signature
        and return; on a CUDA device the clock stops after
        ``torch.cuda.synchronize``, so the time covers the card's work
        (the launches alone return before it is done)."""
        cuda = self.device.type == "cuda"

        def profiled_step(*args, **kw):
            t0 = self._clock()
            out = step_fn(*args, **kw)
            if cuda:
                torch.cuda.synchronize(self.device)
            elapsed = self._clock() - t0
            loss = self._extract_loss(out)
            self.observe(elapsed, loss=loss)
            return out

        profiled_step.profiler = self
        return profiled_step

    def _extract_loss(self, out: Any) -> Optional[float]:
        """Pull the scalar loss out of the step's ``(state, metrics)``
        return shape when present; never raises."""
        try:
            if isinstance(out, tuple) and len(out) == 2:
                metrics = out[1]
                if isinstance(metrics, dict) and self._loss_key in metrics:
                    return float(metrics[self._loss_key])
        except Exception:
            pass
        return None

    def summary(self) -> dict:
        """One dict for logs and benches: first-step split, steady-state
        mean, throughput and MFU."""
        mean = self.mean_step_time()
        tps, mfu = self._throughput(mean) if mean else (None, None)
        return {
            "job": self.job,
            "steps": self.step_count,
            "compile_time_s": (round(self.compile_time_s, 6)
                               if self.compile_time_s is not None else None),
            "mean_step_time_s": round(mean, 6) if mean else None,
            "tokens_per_sec": round(tps, 3) if tps is not None else None,
            "mfu": round(mfu, 6) if mfu is not None else None,
        }


def read_step_log(path: str) -> dict:
    """Aggregate a StepProfiler JSONL log into a bench-trend ``parsed``
    record: mean steady-state step time and tokens/sec over the
    non-compile lines.  A log with no steady-state steps classifies as
    skipped (no throughput signal)."""
    steps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and not rec.get("compile"):
                if isinstance(rec.get("step_time_s"), (int, float)):
                    steps.append(rec)
    if not steps:
        return {"skipped": True,
                "reason": "step log holds no steady-state steps"}
    mean_time = sum(r["step_time_s"] for r in steps) / len(steps)
    tps = [r["tokens_per_sec"] for r in steps
           if isinstance(r.get("tokens_per_sec"), (int, float))]
    if not tps:
        # step time alone trends the wrong way (lower is better); a log
        # recorded without a model shape carries no throughput signal
        return {"skipped": True, "mean_step_time_s": round(mean_time, 6),
                "reason": "step log has no tokens/sec (profiler was "
                          "built without batch/seq_len)"}
    return {
        "unit": "tok/s",
        "value": round(sum(tps) / len(tps), 3),
        "mean_step_time_s": round(mean_time, 6),
        "steps": len(steps),
    }
