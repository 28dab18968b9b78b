"""Time the port's dq kernel (the two-kernel backward's B3) in several
checkouts, in turns, on one card.

    python scripts/time_dq_trees.py ROOT [ROOT ...] \
        [--dtype float32] [--D 256] [--B 2] [--T 2048] [--H 8]

Each ROOT is a checkout of the repo (``.`` for this one, or a copy
unpacked by ``git archive`` into a gitignored directory, with its own
edit to ``csrc/``).  Every tree's kernels are built first, all at once;
then one process a tree calls ``_flash_bwd_dq_cuda`` as the route picks
it on the same seeded causal inputs (lse and delta from that tree's
forward), checks it against the plain version and times it with
``chip_smoke.time_ms`` (profiler device time, CUDA events beside it).
The trees run in the order given, then in reverse, so that each is timed
twice, in turns.  Prints one JSON line a run, then one summary line: for
each tree its two times and its dq's SHA-256 prefix, and whether every
tree gave the same dq bits.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def one(root: str, args) -> dict:
    """One tree's run, in this process."""
    import importlib

    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as c
    from pytorch_operator_tpu_torch import kernels

    fa = importlib.import_module(
        "pytorch_operator_tpu_torch.ops.flash_attention")
    assert os.path.dirname(c.__file__) == root, c.__file__
    assert os.path.dirname(kernels.__file__).startswith(root)
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = args.B, args.T, args.H, args.D
    q, k, v, g = c._flash_inputs(torch, gen, B, T, H, H, D, False,
                                 args.dtype)
    scale = D ** -0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, True, False)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, T).contiguous()
    call = (q, k, v, g, lse.reshape(B * H, T), delta, scale, True, False)
    dq = fa._flash_bwd_dq_cuda(*call)
    ref = fa._flash_bwd_dq_reference(*call)
    torch.cuda.synchronize()
    err = float((dq.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    t = c.time_ms(lambda: fa._flash_bwd_dq_cuda(*call))
    return {"root": root, "ms": t["ms"], "event_ms": t["event_ms"],
            "max_abs_err_over_max_ref": err,
            "dq_sha256": hashlib.sha256(
                dq.cpu().numpy().tobytes()).hexdigest()[:16]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    ap.add_argument("--D", type=int, default=256)
    ap.add_argument("--B", type=int, default=2)
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--H", type=int, default=8)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.roots[0], args)), flush=True)
        return 0
    build = "from pytorch_operator_tpu_torch import kernels; kernels.build()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=root)
             for root in args.roots]
    if any(p.wait() for p in procs):
        raise SystemExit("a tree's kernels did not build")
    flags = [f"--dtype={args.dtype}", f"--D={args.D}", f"--B={args.B}",
             f"--T={args.T}", f"--H={args.H}", "--one"]
    runs = []
    for root in args.roots + args.roots[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              root, *flags], stdout=subprocess.PIPE,
                             text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    by_root = {}
    for r in runs:
        by_root.setdefault(r["root"], {"ms": [], "dq_sha256": set()})
        by_root[r["root"]]["ms"].append(r["ms"])
        by_root[r["root"]]["dq_sha256"].add(r["dq_sha256"])
    shas = {s for r in by_root.values() for s in r["dq_sha256"]}
    print(json.dumps({"shape": [args.B, args.T, args.H, args.D],
                      "dtype": args.dtype,
                      "trees": {k: {"ms": v["ms"],
                                    "dq_sha256": sorted(v["dq_sha256"])}
                                for k, v in by_root.items()},
                      "same_dq_bits": len(shas) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
