"""Compare the SASS of the port's CUDA kernels between two checkouts.

    python scripts/compare_sass.py OLD_ROOT NEW_ROOT \
        [--pair OLD_NAME NEW_NAME ...] [--out FILE]

Compiles every ``pytorch_operator_tpu_torch/csrc/*.cu`` of both trees to
a cubin for sm_90a with the port's own flags (``kernels.ARCH_FLAGS``,
``-std=c++17 -O3``; one nvcc process per source, all started together),
disassembles each with ``cuobjdump -sass`` and compares every kernel's
instructions between the trees, the addresses in the listing dropped.
Kernels are matched by demangled name without arguments
(``flash_bwd_sm90_kernel<__half, 256>``); ``--pair`` maps a name of the
old tree to another of the new one (a kernel that became a template on
more parameters).  Prints one JSON object: for each kernel in both trees
whether its SASS is identical, else how many instruction lines differ
(``--out`` keeps the first DIFF_LINES of them).  Needs the CUDA toolkit
(nvcc, cuobjdump, cu++filt).
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pytorch_operator_tpu_torch import kernels  # noqa: E402

CUDA_BIN = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
DIFF_LINES = 60


def _tool(name: str) -> str:
    path = CUDA_BIN / name
    return str(path) if path.exists() else name


def build_cubins(root: Path, out: Path) -> list[Path]:
    csrc = root / "pytorch_operator_tpu_torch" / "csrc"
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        cubin = out / (src.stem + ".cubin")
        procs.append((cubin, subprocess.Popen(
            [_tool("nvcc"), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-I", str(csrc), "-cubin", str(src), "-o", str(cubin)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for cubin, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {cubin.stem}.cu in {root}:\n"
                             f"{log}")
    return [c for c, _ in procs]


def _short(readable: str) -> str:
    """``void <unnamed>::k<__half, (int)256>(CUtensorMap, ...)`` ->
    ``k<__half, 256>``."""
    for ns in ("(anonymous namespace)::", "<unnamed>::"):
        readable = readable.replace(ns, "")
    readable = re.sub(r"\((?:int|bool|unsigned int)\)", "", readable)
    return readable.removeprefix("void ").split("(")[0]


def _demangle(names: list[str]) -> dict[str, str]:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         stdout=subprocess.PIPE, text=True, check=True)
    return {n: _short(r) for n, r in zip(names, out.stdout.splitlines())}


def sass_by_kernel(cubins: list[Path]) -> dict[str, list[str]]:
    """Each kernel's SASS lines: instruction and encoding, no address."""
    by_mangled: dict[str, list[str]] = {}
    for cubin in cubins:
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              stdout=subprocess.PIPE, text=True,
                              check=True).stdout
        name = None
        for ln in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                name = m.group(1)
                by_mangled[name] = []
                continue
            if name is None or "/*" not in ln:
                continue
            body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
            if body:
                by_mangled[name].append(" ".join(body.split()))
    names = _demangle(list(by_mangled))
    return {names[n]: lines for n, lines in by_mangled.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--pair", nargs=2, action="append", default=[],
                    metavar=("OLD_NAME", "NEW_NAME"))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        sass = {}
        for label, root in (("old", args.old), ("new", args.new)):
            d = Path(tmp) / label
            d.mkdir()
            sass[label] = sass_by_kernel(build_cubins(root.resolve(), d))
    pairs = {new: old for old, new in args.pair}
    pairs.update({n: n for n in sass["new"] if n in sass["old"]
                  and n not in pairs.values()})
    res = {}
    for new, old in sorted(pairs.items()):
        a, b = sass["old"].get(old), sass["new"].get(new)
        if a is None or b is None:
            res[new] = {"old": old, "missing": "old" if a is None else "new"}
            continue
        diff = [ln for ln in difflib.unified_diff(a, b, n=0, lineterm="")
                if ln[:1] in "+-@" and ln[:3] not in ("+++", "---")]
        res[new] = {"old": old, "identical": a == b, "lines": len(b),
                    "differing_lines": sum(ln[:1] != "@" for ln in diff),
                    "diff_head": diff[:DIFF_LINES]}
    report = {"sass": res,
              "only_new": sorted(set(sass["new"]) - set(pairs)),
              "only_old": sorted(set(sass["old"]) - set(pairs.values()))}
    text = json.dumps(report, indent=1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(json.dumps({"sass_identical": {n: r.get("identical")
                                         for n, r in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
