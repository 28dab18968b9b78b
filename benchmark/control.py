"""The readings that a cell's limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--variants fp8,half_batch,no_exchange] [--variants-on 3]

For each seed, in one process a rank: the program's check steps through
the window's own call (one window step, no timing) against the plain
reference in f32, and then each variant of the reference put in the
program's place against the same f32 reference (on the first
``--variants-on`` seeds):

  fp8          the control: every product's operands in float8 e4m3, the
               precision below the configurations' bfloat16
  bf16         a witness: every product's operands in bfloat16, the
               configurations' own precision
  half_batch   a fault: the loss over half of the batch
  no_exchange  a fault: the experts' all-reduce across cards left out

Each line is one seed's numbers (every one ``harness.check.readings``
gives); the last line
gives, for each number, the largest the program read (the lower reading)
and the smallest each variant read (its upper reading).  A state left
unchanged reads 1 on ``change_gap`` by the measure itself and needs no
run.  The benchmark's own runs never run this.
"""

import time

WALL0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.check import NUMBERS  # noqa: E402


def readings_task(cell, device, mesh, gloo, world, rank, seeds, variants,
                  variants_on) -> dict:
    """Every seed's readings on this rank: the program and the f32
    reference (``job.run_rank``), then each variant of the reference."""
    import gc

    import torch
    import torch.distributed as dist

    from benchmark.harness.job import LR, WEIGHT_DECAY, run_rank
    from benchmark.harness.traffic import token_pool
    from benchmark.harness.weights import dims
    from benchmark.reference.model import follow

    config, job = cell.config["config"], cell.job
    group = dist.group.WORLD if world > 1 else None
    out = []
    for seed in seeds:
        r = run_rank(cell, seed, 0.0, False, device, time.time(), mesh=mesh,
                     gloo=gloo, world=world, rank=rank)
        pool = token_pool(cell.traffic, dims(config)["V"], seed, device)
        batches = [pool[i].clone() for i in range(job["check_steps"])]
        del pool
        found = {"seed": seed, "program": r["program"],
                 "reference": r["reference"], "variants": {}}
        for v in (variants if len(out) < variants_on else ()):
            kw = {"matmul": v} if v in ("fp8", "bf16") else {"fault": v}
            found["variants"][v] = follow(
                config, seed, batches, device, lr=LR,
                weight_decay=WEIGHT_DECAY, group=group, **kw)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out.append(found)
    return {"seeds": out}


def summarize(ranks: list) -> list:
    """One line a seed and a last line of lower and upper readings."""
    from benchmark.harness import check
    from benchmark.harness.runner import _merge

    lines, lower, upper = [], {}, {}
    for i, first in enumerate(ranks[0]["seeds"]):
        per = [r["seeds"][i] for r in ranks]
        ref = _merge(per, "reference")
        prog = _merge(per, "program")
        got = check.readings(prog, ref)
        row = {"seed": first["seed"], "program": got["values"],
               "worst": got["worst"]}
        for n in NUMBERS:
            lower[n] = max(lower.get(n, 0.0), row["program"][n])
        for v in first["variants"]:
            vr = _merge([{"v": p["variants"][v]} for p in per], "v")
            row[v] = check.readings(vr, ref)["values"]
            for n in NUMBERS:
                upper.setdefault(v, {})[n] = min(
                    upper.get(v, {}).get(n, float("inf")), row[v][n])
        lines.append(row)
    lines.append({"lower": lower, "upper": upper})
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--variants", default="fp8,half_batch")
    p.add_argument("--variants-on", type=int, default=3,
                   help="run the variants on this many of the seeds")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (tests, tiny cells)")
    p.add_argument("--root", default=str(ROOT))
    args = p.parse_args(argv)
    from benchmark.harness import runner, spec

    cell = spec.cell(args.workload, args.root)
    seeds = [int(s) for s in args.seeds.split(",")]
    variants = [v for v in args.variants.split(",") if v]
    device_type = "cpu" if args.cpu else "cuda"
    import torch

    if device_type == "cuda":
        from pytorch_operator_tpu_torch import kernels

        kernels.build()
    if cell.chips == 1:
        device = torch.device(device_type, 0) if device_type == "cuda" \
            else torch.device("cpu")
        ranks = [readings_task(cell, device, None, None, 1, 0, seeds,
                               variants, args.variants_on)]
    else:
        ranks = runner.on_ranks(cell, device_type, args.root, readings_task,
                                seeds, variants, args.variants_on,
                                seconds=3000.0)
    runner.stop_resource_tracker()
    for line in summarize(ranks):
        print(json.dumps(line), flush=True)
    print(json.dumps({"control_s": time.time() - WALL0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
