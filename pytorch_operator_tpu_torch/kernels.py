"""Build and bind the port's hand-written CUDA kernels.

``csrc/*.cu`` hold the kernels, each behind a plain C entry point that
launches on the caller's stream and returns ``cudaGetLastError()``.  At
first use ``nvcc`` compiles every source for ``sm_90a`` (one process
per source, all started together), links the objects into one shared
library under ``csrc/build/`` and ``ctypes`` loads it.  The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Nothing here falls back: a missing ``nvcc``, a failed build or a launch
that returns an error raises.  Importing this module builds nothing.

Each kernel is a ``CudaKernel`` whose ``launches`` counts the launches
it made, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None

# every CudaKernel by its C symbol, for reset_launches() / launch_counts()
KERNELS: dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from csrc/ at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libptt_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is current.

    Returns the library's path; the compiler's output (register and
    spill counts from ``-Xptxas -v``) is kept beside it as ``.log``.
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
             "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load() -> ctypes.CDLL:
    """Build if needed and load the kernels' shared library (once)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ptt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class CudaKernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        KERNELS[symbol] = self

    def __call__(self, *args) -> None:
        lib = load()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            msg = lib.ptt_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: launch failed with CUDA "
                               f"error {rc} ({msg})")
        self.launches += 1


def on_cuda(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; any other device
    raises, and so does a ``DTensor`` among ``x`` and ``others``: the
    kernels and their plain versions take each rank's local tensors
    (the tensor-parallel layers hand those on), so a sharded tensor here
    is a bug and never goes to the plain version."""
    for t in (x, *others):
        if isinstance(t, DTensor):
            raise TypeError(
                f"a DTensor ({t.placements} on {t.device_mesh}) reached a "
                f"kernel wrapper; the port's ops take local tensors")
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the port's ops run on cuda or cpu tensors, got "
                     f"{x.device}")


def dispatch(x: torch.Tensor, kernel_fn, plain_fn, *args):
    """``kernel_fn(*args)`` when ``x`` is a CUDA tensor, ``plain_fn(*args)``
    when it is a CPU tensor; any other device raises.  A CUDA tensor never
    falls back to the plain version."""
    return kernel_fn(*args) if on_cuda(x) else plain_fn(*args)


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """Every kernel's launches in this process, 0 for one whose op a
    process never imported (an entry point that runs none of the ops
    still reports each kernel)."""
    from pytorch_operator_tpu_torch.ops import (  # noqa: F401  registers
        flash_attention,
        rms_norm,
    )
    return {name: k.launches for name, k in KERNELS.items()}
