"""The torch port stands alone: no JAX, no JAX package, no silent CPU.

``tests/conftest.py`` imports JAX into every test process, so the import
check runs in a fresh interpreter.
"""

import ctypes
import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import chip_smoke

from pytorch_operator_tpu_torch import (default_device, dist_allreduce,
                                        kernels, train_resnet)
from pytorch_operator_tpu_torch.models import llama, resnet

# the modules (ops/__init__ re-exports functions of the same names)
fa = importlib.import_module("pytorch_operator_tpu_torch.ops.flash_attention")
rn = importlib.import_module("pytorch_operator_tpu_torch.ops.rms_norm")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_python(code, env=None):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_and_chip_smoke_import_no_jax():
    res = run_python("""
        import importlib, pkgutil, sys
        import pytorch_operator_tpu_torch as pkg
        mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                      pkg.__name__ + ".")]
        for m in mods:
            importlib.import_module(m)
        assert {pkg.__name__ + "." + m for m in (
            "models.resnet", "train_resnet", "dist_allreduce",
            "telemetry.push", "launch")} <= set(mods)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "pytorch_operator_tpu"
                     or m.startswith("pytorch_operator_tpu."))
        print(len(mods), bad)
        """)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 20  # every module of the package was imported
    assert bad.strip() == "[]"


def test_launch_counts_name_every_kernel_in_a_process_without_ops():
    """A process that imported no op module (dist_allreduce's) still
    reports every kernel in its ranks' ``launches=`` lines, with 0."""
    res = run_python("""
        import json, sys
        from pytorch_operator_tpu_torch import dist_allreduce, kernels
        assert "pytorch_operator_tpu_torch.ops" not in sys.modules
        print(json.dumps(kernels.launch_counts()))
    """)
    counts = json.loads(res.stdout.strip().splitlines()[-1])
    assert counts == {name: 0 for name in chip_smoke.KERNEL_INFO}


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    res = run_python("""
        import pytorch_operator_tpu_torch.ops.flash_attention
        import pytorch_operator_tpu_torch.ops.rms_norm
        from pytorch_operator_tpu_torch import kernels
        assert kernels._lib is None, "importing loaded the library"
        assert sorted(kernels.KERNELS) == [
            "flash_bwd", "flash_bwd_dkv", "flash_bwd_dkv_sm90",
            "flash_bwd_dq", "flash_bwd_dq_sm90", "flash_bwd_sm90",
            "flash_fwd", "flash_fwd_sm90", "rms_norm_fwd",
            "rms_norm_rowblock_fwd"], kernels.KERNELS
        try:
            kernels.build()
        except RuntimeError as e:
            assert "nvcc not found" in str(e)
        else:
            raise AssertionError("build without nvcc did not raise")
        print("ok")
        """, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


class TestDefaultDevice:
    def test_cpu_only_when_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for asked in (None, "cuda", torch.device("cuda:0")):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                default_device(asked)
        assert default_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError):
            default_device("meta")

    def test_model_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            llama.Llama(llama.tiny(n_layers=1))

    @pytest.mark.parametrize("entry", [
        lambda: resnet.resnet50(), lambda: resnet.resnet18_thin(),
        lambda: train_resnet.main(["--tiny", "--steps", "1"]),
        lambda: dist_allreduce.main([])])
    def test_resnet_and_the_seams_default_to_cuda(self, monkeypatch, entry):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


@pytest.fixture()
def no_toolkit(tmp_path, monkeypatch):
    """A machine without nvcc, and a build directory of its own."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_lib", None)
    return tmp_path / "build"


def _cuda_wrappers():
    """Each kernel's wrapper, called with (CPU) tensors it takes: bf16 at
    D 64 for the Hopper flash kernels, f32 for the WMMA ones."""
    x = torch.randn(8, 64).bfloat16()
    w = torch.ones(64).bfloat16()
    q = torch.randn(1, 16, 2, 64).bfloat16()
    q32 = q.float()
    lse = torch.zeros(2, 16)
    return {
        "rms_norm_fwd": lambda: rn.rms_norm_cuda(x, w, 1e-5),
        "rms_norm_rowblock_fwd": lambda: rn.rms_norm_cuda(
            x, w, 1e-5, kernel=rn.ROWBLOCK_KERNEL),
        "flash_fwd_sm90": lambda: fa._flash_fwd_cuda(q, q, q, 0.125, True,
                                                     False),
        "flash_bwd_sm90": lambda: fa._flash_bwd_cuda(q, q, q, q, lse, lse,
                                                     0.125, True, False),
        "flash_fwd": lambda: fa._flash_fwd_cuda(q32, q32, q32, 0.125, True,
                                                False),
        "flash_bwd": lambda: fa._flash_bwd_cuda(q32, q32, q32, q32, lse, lse,
                                                0.125, True, False),
        "flash_bwd_dq_sm90": lambda: fa._flash_bwd_dq_cuda(
            q, q, q, q, lse, lse, 0.125, True, False),
        "flash_bwd_dkv_sm90": lambda: fa._flash_bwd_dkv_cuda(
            q, q, q, q, lse, lse, 0.125, True, False),
        "flash_bwd_dq": lambda: fa._flash_bwd_dq_cuda(
            q32, q32, q32, q32, lse, lse, 0.125, True, False),
        "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_cuda(
            q32, q32, q32, q32, lse, lse, 0.125, True, False),
    }


KERNEL_NAMES = ["rms_norm_fwd", "rms_norm_rowblock_fwd", "flash_fwd_sm90",
                "flash_bwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90",
                "flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"]


def _dummy_args(kernel):
    return [a(0) if a is not ctypes.c_void_p else a(None)
            for a in kernel.argtypes]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_refuses_cpu_tensors_and_builds_nothing(no_toolkit, name):
    """The CUDA path given CPU tensors raises; it does not take the plain
    version in their place."""
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda_wrappers()[name]()
    assert kernels.launch_counts() == before
    assert not no_toolkit.exists()
    assert kernels._lib is None


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_without_toolkit_raises_and_counts_nothing(no_toolkit, name):
    k = kernels.KERNELS[name]
    before = k.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k(*_dummy_args(k))
    assert k.launches == before
    assert not no_toolkit.exists() or not any(no_toolkit.glob("*.so"))
    assert kernels._lib is None


class _FakeLib:
    """Stands in for the built library: every entry returns ``rc``."""

    def __init__(self, rc):
        self.rc = rc
        self.ptt_cuda_error_string = lambda rc: b"fake error"

    def __getattr__(self, symbol):
        def entry(*args):
            return self.rc
        return entry


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_launch_counts_only_launches_that_succeed(monkeypatch, name):
    k = kernels.KERNELS[name]
    start = k.launches
    monkeypatch.setattr(kernels, "load", lambda: _FakeLib(0))
    k(*_dummy_args(k))
    assert k.launches == start + 1
    monkeypatch.setattr(kernels, "load", lambda: _FakeLib(700))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k(*_dummy_args(k))
    assert k.launches == start + 1
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}


def test_pointers_and_stream_are_void_p():
    for k in kernels.KERNELS.values():
        assert ctypes.c_void_p in k.argtypes
        assert k.argtypes[-1] is ctypes.c_void_p  # the stream
    assert isinstance(kernels.ptr(torch.ones(2)), ctypes.c_void_p)


class TestWrappersRefuseWhatTheKernelsDoNotTake:
    @pytest.mark.parametrize("dtype,wdtype", [
        (torch.float64, torch.float32), (torch.float16, torch.float64)])
    def test_rms_norm_dtype(self, dtype, wdtype):
        # f32, bf16 and fp16 are taken in any pair; f64 on either side is
        # refused before the device is looked at
        with pytest.raises(TypeError):
            rn.rms_norm_cuda(torch.ones(4, 8, dtype=dtype),
                             torch.ones(8, dtype=wdtype), 1e-5)

    @pytest.mark.parametrize("dtype,D,exc", [
        (torch.float64, 64, TypeError), (torch.float32, 320, ValueError),
        (torch.bfloat16, 320, ValueError), (torch.float16, 300, ValueError)])
    def test_flash_dtype_and_head_dim(self, dtype, D, exc):
        q = torch.ones(1, 8, 2, D, dtype=dtype)
        with pytest.raises(exc):
            fa._flash_fwd_cuda(q, q, q, 1.0, True, False)

    def test_other_devices_do_not_fall_back(self):
        x = torch.ones(4, 8, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            rn.rms_norm(x, torch.ones(8, device="meta"))
        q = torch.ones(1, 8, 2, 64, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            fa.flash_attention(q, q, q)
