"""A cell's traced run with the port's spans on: each step's device time
by span and kernel class, beside the same steps with the spans off.

    python3 benchmark/spans_run.py --workload <cell> --seed <n> \\
        --seconds <s>

Run from the root of a checkout, on the cards the cell asks for.  The
cell runs as ``run.py --trace 1`` runs it (set-up, check steps, window,
reference), except that its profile of steady steps is taken eight
times, back to back on every rank: with the port's spans off, on, on
and off, twice (``ORDER``).  ``harness/spans.py`` reduces each trace,
and the port's ``expert_tokens`` counter is read.  Prints one JSON
object with, for each profile of rank 0: the per-layer metrics of
``BENCHMARK.json`` and those of ``SPAN_METRICS``, the device and host
ms a step, ``span_ms`` and ``span_idle_ms`` a step and the owners' sum
over the trace's kernel total.  Exits as ``run.py`` does.
"""

import time

WALL0 = time.time()  # the run's start, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as run_py  # noqa: E402  (caches, device check)

# the per-layer metrics the port's spans and counter feed; their readers
# are in metrics/ beside the others
SPAN_METRICS = ("attention_ms", "ffn_ms", "norm_ms", "head_ce_ms",
                "global_norm_ms", "expert_load_max_ratio")


# spans off, on, on, off, twice: a drift over the profiles moves both
# sides alike
ORDER = (False, True, True, False) * 2


def profile_abba(run_step, first: int, steps: int, device) -> dict:
    """``job.profile_steps``' profile of ``steps`` steady steps taken
    eight times back to back, the port's spans off, on, on, off, twice
    (``ORDER``): {"profiles": their summaries}.  Each is taken up to
    three times while it lacks a record of a launch the port counted."""
    profiles = []
    for on in ORDER:
        summary, first = _profile(run_step, first, steps, device, on)
        profiles.append(summary)
    return {"profiles": profiles}


def _profile(run_step, k: int, steps: int, device, on: bool):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import job
    from benchmark.harness import profile as prof_mod
    from benchmark.harness import spans
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.telemetry import spans as port_spans

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for take in range(1, 4):
        job._sync(device)
        if dist.is_initialized():
            # the ranks enter each profile together: a rank still reducing
            # its last trace would hold the others in their all-reduces
            dist.barrier(device_ids=[device.index]
                         if device.type == "cuda" else None)
            job._sync(device)
        port_spans.take_counts()
        before = kernels.launch_counts()
        with port_spans.enabled(on), profile(activities=acts) as prof:
            t = time.perf_counter()
            events = [job._event(device)]
            for _ in range(steps):
                run_step(k)
                k += 1
                events.append(job._event(device))
            job._sync(device)
            host_ms = (time.perf_counter() - t) * 1e3 / steps
        after = kernels.launch_counts()
        summary = prof_mod.summarize(prof, steps)
        summary.update(spans.reduce(prof))
        del prof
        summary["expert_tokens"] = spans.expert_tokens(
            port_spans.take_counts())
        summary["device_ms"] = (events[0].elapsed_time(events[-1])
                                if device.type == "cuda" else 0.0)
        summary["host_ms_per_step"] = host_ms
        summary["takes"] = take
        launched = {s: after[s] - before.get(s, 0) for s in after}
        if device.type != "cuda" or prof_mod.complete(summary, launched):
            return summary, k
    raise RuntimeError(f"the profiler dropped records of the port's "
                       f"launches in {take} takes of {steps} steps")


def _task(cell, device, mesh, gloo, world, rank, seed, seconds, wall0):
    """One rank of a cell on several devices (``runner.Ranks``)."""
    from benchmark.harness import job

    job.profile_steps = profile_abba
    return job.run_rank(cell, seed, seconds, True, device, wall0,
                        mesh=mesh, gloo=gloo, world=world, rank=rank)


def _metrics(cell, results, i: int, device_type: str) -> dict:
    from benchmark.harness import runner, spec

    run = runner.record(cell, [dict(r, trace=r["trace"]["profiles"][i])
                               for r in results],
                        device_type, results[0]["device_name"])
    names = [m["name"] for m in cell.per_layer] + list(SPAN_METRICS)
    return {n: spec.reader(n, cell.bench_dir)(run) for n in names}


def _reading(cell, results, i: int, device_type: str) -> dict:
    """What rank 0's ``i``-th profile gives, a step where it is time."""
    p = results[0]["trace"]["profiles"][i]
    n = p["steps"]
    owned = sum(sum(by.values()) for by in p["span_ms"].values())
    return {
        "spans": ORDER[i],
        "metrics": _metrics(cell, results, i, device_type),
        "device_ms_per_step": p["device_ms"] / n,
        "host_ms_per_step": p["host_ms_per_step"],
        "total_kernel_ms_per_step": p["total_kernel_ms"] / n,
        "span_ms_per_step": {o: {c: ms / n for c, ms in by.items()}
                             for o, by in p["span_ms"].items()},
        "span_idle_ms_per_step": {o: ms / n for o, ms in
                                  p["span_idle_ms"].items()},
        "owned_over_total": (owned / p["total_kernel_ms"]
                             if p["total_kernel_ms"] else None),
        "unowned_ops": p["unowned_ops"], "doubled": p["doubled"],
        "expert_tokens": p["expert_tokens"], "idle_gaps": p["idle_gaps"]}


def run(cell_name: str, seed: int, seconds: float,
        device_type: str = "cuda", root=None, wall0: float | None = None,
        precheck=None) -> dict:
    """The cell's profiles, as the module docstring says."""
    from benchmark.harness import job, runner, spec

    wall0 = time.time() if wall0 is None else wall0
    root = spec.ROOT if root is None else root
    cell = spec.cell(cell_name, root)
    if precheck is not None:
        precheck(cell)
    if cell.chips == 1:
        job.profile_steps = profile_abba
        results = [runner._one_rank(cell, device_type, seed, seconds, True,
                                    wall0)]
    else:
        results = runner.on_ranks(cell, device_type, root, _task, seed,
                                  seconds, wall0)
    return {"workload": cell_name, "seed": seed,
            "device": results[0]["device_name"],
            "steps": results[0]["trace"]["profiles"][0]["steps"],
            "profiles": [_reading(cell, results, i, device_type)
                         for i in range(len(ORDER))]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from benchmark.harness import runner

    def go() -> int:
        print(json.dumps(run(args.workload, args.seed, args.seconds,
                             "cuda", wall0=WALL0,
                             precheck=run_py.device_check)), flush=True)
        return 0

    return runner.main_guarded(go)


if __name__ == "__main__":
    sys.exit(main())
