"""Time the port's dq kernel (the two-kernel backward's B3), or with
``--kernel`` the fused backward (B2) or the dk / dv kernel (B4), in
several checkouts, in turns, on one card.

    python scripts/time_dq_trees.py ROOT [ROOT ...] [--kernel dq] \
        [--dtype float32] [--D 256] [--B 2] [--T 2048] [--H 8]

Each ROOT is a checkout of the repo (``.`` for this one, or a copy
unpacked by ``git archive`` into a gitignored directory, with its own
edit to ``csrc/``).  Every tree's kernels are built first, all at once;
then one process a tree calls the kernel's wrapper (``_flash_bwd_dq_
cuda``, ``_flash_bwd_cuda`` or ``_flash_bwd_dkv_cuda``) as the route
picks it on the same seeded causal inputs (lse and delta from that
tree's forward), checks it against the plain version and times it with
``chip_smoke.time_ms`` (profiler device time, CUDA events beside it).
The trees run in the order given, then in reverse, so that each is timed
twice, in turns.  Prints one JSON line a run, then one summary line: for
each tree its two times and the SHA-256 prefix of its deterministic
output (dq of B3; dk and dv of B2 and B4: B2's dq sums with atomics),
and whether every tree gave the same bits.  Needs a CUDA card and nvcc.
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
    kernel = {"dq": fa._flash_bwd_dq_cuda, "bwd": fa._flash_bwd_cuda,
              "dkv": fa._flash_bwd_dkv_cuda}[args.kernel]
    plain = {"dq": fa._flash_bwd_dq_reference, "bwd": fa._flash_bwd_reference,
             "dkv": fa._flash_bwd_dkv_reference}[args.kernel]
    outs, refs = kernel(*call), plain(*call)
    if args.kernel == "dq":
        outs, refs = (outs,), (refs,)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()
                    / b.float().abs().max()) for a, b in zip(outs, refs))
    bits = hashlib.sha256()
    for x in outs[-2:] if args.kernel != "dq" else outs:
        bits.update(x.cpu().numpy().tobytes())
    t = c.time_ms(lambda: kernel(*call))
    return {"root": root, "ms": t["ms"], "event_ms": t["event_ms"],
            "max_abs_err_over_max_ref": err,
            "sha256": bits.hexdigest()[:16]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--kernel", default="dq", choices=("dq", "bwd", "dkv"))
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
    flags = [f"--kernel={args.kernel}", f"--dtype={args.dtype}",
             f"--D={args.D}", f"--B={args.B}",
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
        by_root.setdefault(r["root"], {"ms": [], "sha256": set()})
        by_root[r["root"]]["ms"].append(r["ms"])
        by_root[r["root"]]["sha256"].add(r["sha256"])
    shas = {s for r in by_root.values() for s in r["sha256"]}
    print(json.dumps({"kernel": args.kernel,
                      "shape": [args.B, args.T, args.H, args.D],
                      "dtype": args.dtype,
                      "trees": {k: {"ms": v["ms"],
                                    "sha256": sorted(v["sha256"])}
                                for k, v in by_root.items()},
                      "same_bits": len(shas) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
