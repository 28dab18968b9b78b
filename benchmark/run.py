"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints earlier lines (set-up by part,
the port's launches a step, the window, the readings compared) and, as
its last line, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers end
standard error.  Exits 2 without a CUDA device or with fewer than the
cell asks for, and 1 on any other failure, printing no result.
"""

import time

WALL0 = time.time()  # the run's start, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a library may keep, at fixed paths inside the checkout
CACHE = ROOT / "benchmark" / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_check(cell) -> None:
    """Raise ``runner.NoDevice`` unless the machine has the CUDA devices
    the cell asks for."""
    import torch

    from benchmark.harness.runner import NoDevice

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the port on "
                       "the card")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"{cell.name} needs {cell.chips} CUDA devices, "
                       f"{torch.cuda.device_count()} found")


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import runner

    def go() -> int:
        line, earlier, checks = runner.execute(
            args.workload, args.seed, args.seconds, bool(args.trace),
            "cuda", WALL0, precheck=device_check)
        for obj in earlier:
            print(json.dumps(obj), flush=True)
        for text in checks:
            print(text, file=sys.stderr, flush=True)
        print(json.dumps(line), flush=True)
        return 0

    return runner.main_guarded(go)


if __name__ == "__main__":
    sys.exit(main())
