"""A run of one cell, from its files to the contract's last line.

A cell on one card runs in this process; a cell on several starts one
process a card (``multiprocessing``, spawn), each with its NCCL process
group and a gloo group for host-side agreement, as a pod of the
operator would, and prints rank 0's line with the whole cell's numbers.
The ranks start before this process imports torch, and rank 0 builds
the kernel library while the others wait, so the imports are paid once
on the way to the window, in parallel.  ``execute`` also runs on the
CPU, for the tests, where no device metric is reported.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import socket
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

from benchmark.harness import check, isolation, spec

PLATFORM = {"cuda": "gpu", "cpu": "cpu"}
# the whole run ends within the contract's 360 s; the workers get this
# long before they are stopped
WORKER_SECONDS = 330.0


class NoDevice(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _merge(results: list, key: str) -> dict:
    """One side's readings over the ranks: the losses of rank 0 (the
    step's loss is the mesh's mean, the same on every rank) and each
    leaf's norms from the rank that holds it (rank 0's for a leaf every
    rank holds)."""
    out = {"losses": results[0][key]["losses"]}
    for part in ("grad_norms", "change_norms"):
        merged = {}
        for r in reversed(results):
            merged.update(r[key][part])
        out[part] = merged
    if key == "program":
        out["nonfinite_losses"] = max(r[key]["nonfinite_losses"]
                                      for r in results)
    return out


def record(cell, results: list, device_type: str, name: str | None) -> dict:
    """What the readers take: the cell's shapes, rank 0's window and
    trace, every rank's traces and the fullest rank's peak memory."""
    r0 = results[0]
    mesh = cell.job["mesh"] or {}
    data_ranks = mesh.get("dp", 1) * mesh.get("fsdp", 1)
    B, T = cell.traffic["batch"], cell.traffic["seq_len"]
    peaks = [r["peak_bytes"] for r in results if r["peak_bytes"] is not None]
    return {"platform": PLATFORM[device_type], "kind": name,
            "chips": cell.chips, "config": cell.config["config"],
            "job": cell.job, "global_batch": B, "seq_len": T,
            "local_batch": B // data_ranks,
            "steps": r0["steps"], "wall_s": r0["wall_s"],
            "step_ms": r0["step_ms"], "setup_s": r0["setup_s"],
            "peak_bytes": max(peaks) if peaks else None,
            "trace": r0["trace"],
            "traces": [r["trace"] for r in results if r["trace"]]}


def metrics(cell, run: dict, trace: bool) -> dict:
    """The cell's end-to-end (``trace`` false) or per-layer metrics, each
    from its reader; a reader that finds nothing to read gives None and
    its metric is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_block(run: dict) -> dict:
    out = {"platform": run["platform"], "kind": run["kind"],
           "count": run["chips"], "memory_peak_bytes": run["peak_bytes"]}
    traces = [t for t in run["traces"] if t["window_s"] > 0]
    if traces:
        out["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        out["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
    return out


def conclude(cell, results: list, trace: bool, device_type: str,
             name: str | None) -> tuple[dict, list, list]:
    """The last line, the earlier lines and the check lines of a run from
    every rank's results."""
    prog, ref = _merge(results, "program"), _merge(results, "reference")
    verdict = check.compare(prog, ref, cell.job["limits"])
    run = record(cell, results, device_type, name)
    r0 = results[0]
    earlier = [
        {"startup": r0["startup"]},
        {"setup_parts": {**r0["setup_parts"], "setup_s": r0["setup_s"]}},
        {"launches_per_step": r0["launches_per_step"]},
        {"window": {"steps": r0["steps"], "wall_s": r0["wall_s"],
                    "step_ms_median": statistics.median(r0["step_ms"])
                    if r0["step_ms"] else None},
         "reference_s": r0["reference_s"]},
        {"readings": {"program_losses": prog["losses"],
                      "reference_losses": ref["losses"],
                      **verdict["values"], "worst": verdict["worst"],
                      "quiet_leaves": verdict["quiet_leaves"]}},
    ]
    if trace and r0["trace"] is not None:
        earlier.append({"trace": {k: v for k, v in r0["trace"].items()
                                  if k not in ("device_ops", "idle_gaps")}})
    line = {"correct": verdict["correct"], "attempted": r0["steps"],
            "failed": prog["nonfinite_losses"],
            "metrics": metrics(cell, run, trace),
            "device": device_block(run)}
    if trace and r0["trace"] is not None:
        line["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                             "idle_gaps": r0["trace"]["idle_gaps"]}
    line["checks"] = verdict["checks"]
    return line, earlier, check.check_lines(verdict["checks"])


def init_rank(rank: int, world: int, port: int, device_type: str):
    """This process's device, its process group (NCCL on the card, gloo
    on the CPU) and a gloo group for the host's own agreement."""
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    gloo = (dist.new_group(backend="gloo") if device_type == "cuda"
            else dist.group.WORLD)
    return device, gloo


def _worker(rank: int, world: int, port: int, out_dir: str, task, args
            ) -> None:
    """One rank of a cell on several devices: ``task(cell, device, mesh,
    gloo, world, rank, *args)``, whose results rank 0 writes for the
    parent.  On the card rank 0 builds the kernel library (a checkout's
    first run) while the others wait."""
    try:
        import torch.distributed as dist

        from pytorch_operator_tpu_torch import kernels
        from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh

        cell_name, root, device_type, wall0 = args[:4]
        imports_s = time.time() - wall0
        cell = spec.cell(cell_name, root)
        device, gloo = init_rank(rank, world, port, device_type)
        t = time.perf_counter()
        if device_type == "cuda" and rank == 0:
            kernels.build()
        dist.barrier(group=gloo)
        startup = {"imports_s": imports_s,
                   "library_build_s": time.perf_counter() - t}
        mesh = make_named_mesh(dict(cell.job["mesh"]), device_type)
        result = task(cell, device, mesh, gloo, world, rank, *args[4:])
        result["startup"] = startup
        result["device_name"] = _device_name(device)
        result["forbidden"] = isolation.forbidden()
        gathered = [None] * world
        dist.all_gather_object(gathered, result, group=gloo)
        if rank == 0:
            with open(os.path.join(out_dir, "ranks.json"), "w") as f:
                json.dump(gathered, f)
    except Exception:  # the rank's boundary: report, and leave at once
        # (tearing the process group down would wait on the other ranks'
        # collectives, which never come)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def _device_name(device) -> str | None:
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else None)


def _window_task(cell, device, mesh, gloo, world, rank, seed, seconds,
                 trace, wall0) -> dict:
    return run_rank(cell, seed, seconds, trace, device, wall0, mesh=mesh,
                    gloo=gloo, world=world, rank=rank)


class Ranks:
    """``task`` started on one spawned process a rank of ``cell``, before
    this process imports torch; ``wait`` gives every rank's result, or
    raises, and ``stop`` ends every process that is still running."""

    def __init__(self, cell, device_type: str, root, task, *args,
                 wall0: float | None = None,
                 seconds: float = WORKER_SECONDS):
        self.seconds = seconds
        self.out_dir = tempfile.mkdtemp(prefix="bench-ranks-")
        wall0 = time.time() if wall0 is None else wall0
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self.procs = [ctx.Process(
            target=_worker, args=(rank, cell.chips, port, self.out_dir,
                                  task, (cell.name, str(root), device_type,
                                         wall0, *args)))
            for rank in range(cell.chips)]
        self.t0 = time.perf_counter()
        for p in self.procs:
            p.start()

    def wait(self) -> list:
        try:
            while True:
                codes = [p.exitcode for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} exited with code "
                                       f"{codes[failed[0]]}")
                if all(c == 0 for c in codes):
                    break
                if time.perf_counter() - self.t0 > self.seconds:
                    raise TimeoutError(f"the ranks took over "
                                       f"{self.seconds} s")
                self.procs[codes.index(None)].join(timeout=2)
            with open(os.path.join(self.out_dir, "ranks.json")) as f:
                return json.load(f)
        finally:
            self.stop()

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=30)
        shutil.rmtree(self.out_dir, ignore_errors=True)


def on_ranks(cell, device_type: str, root, task, *args,
             seconds: float = WORKER_SECONDS) -> list:
    """``task`` on one spawned process a rank of ``cell``; every rank's
    result, or an error.  Every process is ended before it returns."""
    return Ranks(cell, device_type, root, task, *args,
                 seconds=seconds).wait()


def _window_task(cell, device, mesh, gloo, world, rank, seed, seconds,
                 trace, wall0) -> dict:
    from benchmark.harness.job import run_rank

    return run_rank(cell, seed, seconds, trace, device, wall0, mesh=mesh,
                    gloo=gloo, world=world, rank=rank)


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device_type: str = "cuda", wall0: float | None = None,
            root: Path | str = spec.ROOT, precheck=None
            ) -> tuple[dict, list, list]:
    """Run the cell and return (last line, earlier lines, check lines).
    ``precheck(cell)``, which may raise, runs once the ranks of a cell
    on several devices have started.  Raises if a rank loaded JAX or the
    JAX package."""
    wall0 = time.time() if wall0 is None else wall0
    cell = spec.cell(cell_name, root)
    if cell.chips == 1:
        if precheck is not None:
            precheck(cell)
        results = [_one_rank(cell, device_type, seed, seconds, trace,
                             wall0)]
    else:
        ranks = Ranks(cell, device_type, root, _window_task, seed, seconds,
                      trace, wall0, wall0=wall0)
        try:
            if precheck is not None:
                precheck(cell)
            results = ranks.wait()
        finally:
            ranks.stop()
    found = sorted({m for r in results for m in r["forbidden"]}
                   | set(isolation.forbidden()))
    if found:
        raise RuntimeError(f"loaded JAX or the JAX package: {found}")
    return conclude(cell, results, trace, device_type,
                    results[0]["device_name"])


def _one_rank(cell, device_type: str, seed: int, seconds: float,
              trace: bool, wall0: float) -> dict:
    """A cell on one device, in this process."""
    import torch

    from benchmark.harness.job import run_rank
    from pytorch_operator_tpu_torch import kernels

    imports_s = time.time() - wall0
    t = time.perf_counter()
    if device_type == "cuda":
        kernels.build()
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    startup = {"imports_s": imports_s,
               "library_build_s": time.perf_counter() - t}
    result = run_rank(cell, seed, seconds, trace, device, wall0)
    result["startup"] = startup
    result["device_name"] = _device_name(device)
    result["forbidden"] = isolation.forbidden()
    return result


def stop_resource_tracker() -> None:
    """End the helper process that ``multiprocessing`` starts beside
    spawned ranks, and wait for it: left alone it ends only after this
    process has, as an orphan."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


def main_guarded(fn) -> int:
    """Run ``fn`` and map a failure to exit code 1 with its traceback on
    standard error, or to 2 where the machine lacks the devices (no
    result line).  Every helper process has ended when it returns."""
    try:
        return fn()
    except NoDevice as e:
        print(e, file=sys.stderr)
        return 2
    except Exception:  # the run's boundary: report and fail
        traceback.print_exc()
        return 1
    finally:
        stop_resource_tracker()
