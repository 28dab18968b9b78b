"""Time the port's RMSNorm kernel (B5) as several checkouts build it, in
turns, on one card.

    python scripts/time_rms_norm_trees.py ROOT [ROOT ...] \
        [--N 4096] [--D 4096] [--dtype bfloat16] [--wdtype bfloat16]

Each ROOT is a checkout of the repo (``.`` for this one, or a copy
unpacked by ``git archive`` into a gitignored directory, with its own
edit to ``pytorch_operator_tpu_torch/csrc/rms_norm.cu``).  Only that file
is built, by nvcc with the port's flags, into a library of its own for
each tree, all at once: seconds, where ``time_dq_trees.py`` builds every
kernel of every tree.  Then, in this process, each tree's
``rms_norm_fwd`` (the C entry that takes the weight's dtype) runs on the
same seeded (N, D) input: its output is held against
``rms_norm_reference`` within one ulp of the output dtype and hashed,
and it is timed with ``chip_smoke.time_ms`` (profiler device time, CUDA
events beside it; four copies of x cycled, so that no launch finds its
input in the 50 MB L2), the trees in the order given, then in reverse.
Prints one JSON line a timing, then a summary line: for each tree its two
times, its share of the byte bound, the registers and spill bytes ptxas
gave each kernel of the file, and the SHA-256 prefix of its output.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as c  # noqa: E402
from pytorch_operator_tpu_torch import kernels  # noqa: E402


def build(roots: list[str], tmp: str) -> list[tuple[str, dict]]:
    """Each tree's csrc/rms_norm.cu as a shared library: its path and its
    ptxas counts by kernel."""
    procs = []
    for i, root in enumerate(roots):
        csrc = os.path.join(root, "pytorch_operator_tpu_torch", "csrc")
        so = os.path.join(tmp, f"rms_norm_{i}.so")
        procs.append((so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", csrc,
             os.path.join(csrc, "rms_norm.cu"), "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for (so, proc), root in zip(procs, roots):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {root}:\n{log}")
        out.append((so, c.ptxas_by_kernel(log)))
    return out


def main(argv: list[str] | None = None) -> int:
    import importlib

    import torch

    rn = importlib.import_module("pytorch_operator_tpu_torch.ops.rms_norm")

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--D", type=int, default=4096)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--wdtype", default=None)
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    dt = getattr(torch, args.dtype)
    wdt = getattr(torch, args.wdtype or args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    N, D = args.N, args.D
    x = torch.randn(N, D, generator=gen, device="cuda").to(dt)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdt)
    xs = itertools.cycle([x.clone() for _ in range(4)])
    ref = rn.rms_norm_reference(x, w, 1e-5).float()
    b_ms, _ = c.bound(2 * N * D * x.element_size() + D * w.element_size(),
                      4 * N * D, c.PEAK_F32_FLOPS)
    stream = kernels.stream(x.device)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns = []
        for root, (so, ptxas) in zip(roots, build(roots, tmp)):
            fn = ctypes.CDLL(so).rms_norm_fwd
            fn.argtypes = rn.KERNEL.argtypes
            fn.restype = ctypes.c_int

            def call(xi, fn=fn):
                out = torch.empty_like(xi)
                rc = fn(kernels.ptr(xi), kernels.ptr(w), kernels.ptr(out),
                        N, D, 1e-5, rn._DTYPES[dt], rn._DTYPES[wdt], stream)
                assert rc == 0, f"rms_norm_fwd returned CUDA error {rc}"
                return out

            got = call(x)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            ok = bool((err <= c.RMS_ULP[args.dtype] * ref.abs() + 1e-6)
                      .all())
            res[root] = {"ms": [], "event_ms": [], "ok": ok,
                         "max_abs_err": float(err.max()), "ptxas": ptxas,
                         "sha256": hashlib.sha256(
                             got.view(torch.uint8).cpu().numpy().tobytes()
                         ).hexdigest()[:16]}
            fns.append((root, call))
        for root, call in fns + fns[::-1]:
            t = c.time_ms(lambda: call(next(xs)))
            res[root]["ms"].append(t["ms"])
            res[root]["event_ms"].append(t["event_ms"])
            print(json.dumps({"root": root, "ms": t["ms"],
                              "event_ms": t["event_ms"],
                              "clock": t["clock"]}), flush=True)
    for r in res.values():
        r["bound_share"] = b_ms / (sum(r["ms"]) / len(r["ms"]))
    print(json.dumps({"shape": [N, D], "dtype": args.dtype,
                      "wdtype": args.wdtype or args.dtype, "bound_ms": b_ms,
                      "trees": res, "card": c.nvidia_smi()}), flush=True)
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
