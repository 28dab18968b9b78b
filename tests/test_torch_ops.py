"""Parity of the torch port's ops with the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX op (Pallas kernels in
interpret mode, as tests/test_ops.py runs them) and through the port's
counterpart, which on CPU tensors takes its plain PyTorch version.
Tolerances are tests/test_ops.py's: 2e-5 / 1e-4 forward, 5e-5 / 1e-3
gradients.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.ops import flash_attention as jax_flash
from pytorch_operator_tpu.ops import rms_norm as jax_rms_norm
from pytorch_operator_tpu.ops.flash_attention import _auto_block
from pytorch_operator_tpu.ops.flash_attention import (
    flash_with_lse as jax_flash_with_lse,
)
from pytorch_operator_tpu_torch import kernels
from pytorch_operator_tpu_torch.ops import flash_attention, flash_with_lse
from pytorch_operator_tpu_torch.ops import rms_norm
from pytorch_operator_tpu_torch.ops.flash_attention import (
    _dense_path,
    _Flash,
    _flash_bwd_dkv_reference,
    _flash_bwd_dq_reference,
    _flash_bwd_reference,
)

# the modules (ops/__init__ re-exports functions of the same names)
jax_fa = importlib.import_module("pytorch_operator_tpu.ops.flash_attention")
fa = importlib.import_module("pytorch_operator_tpu_torch.ops.flash_attention")

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-3)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def jax_flash_pallas(q, k, v, causal):
    """JAX flash_attention pinned to its Pallas kernels by explicit
    blocks (tests/test_ops.py flash_pallas)."""
    b = _auto_block(q.shape[1], q.shape[-1])
    return jax_flash(q, k, v, causal=causal, block_q=b, block_k=b)


def qkv(seed, B, T, H, Hk, D):
    return (randn(seed, B, T, H, D), randn(seed + 1, B, T, Hk, D),
            randn(seed + 2, B, T, Hk, D))


class TestRmsNorm:
    @pytest.mark.parametrize("shape", [(128, 64), (7, 3, 64)])
    def test_forward_matches_jax(self, shape):
        # (128, 64) takes the JAX Pallas kernel (rows % 64 == 0), the
        # ragged (7, 3, 64) the JAX jnp path
        x, w = randn(0, *shape), randn(1, shape[-1]) + 1.0
        ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), block_rows=64)
        out = rms_norm(t(x), t(w))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)

    def test_grads_match_jax(self):
        x, w = randn(2, 128, 64), randn(3, 64) + 1.0
        gj = jax.grad(
            lambda x, w: jnp.sum(jnp.sin(jax_rms_norm(x, w, block_rows=64))),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt, wt = t(x, True), t(w, True)
        torch.sin(rms_norm(xt, wt)).sum().backward()
        for a, b in zip((xt.grad, wt.grad), gj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


class TestFlashAttention:
    @pytest.mark.parametrize("T,causal,groups", [
        (256, True, 1), (128, False, 1), (256, True, 2), (100, True, 1),
        (130, False, 2)])
    def test_forward_matches_jax(self, T, causal, groups):
        q, k, v = qkv(10, 2, T, 4, 4 // groups, 32)
        ref = jax_flash_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal)
        out = flash_attention(t(q), t(k), t(v), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)

    @pytest.mark.parametrize("T,causal,groups", [
        (128, True, 1), (128, False, 1), (128, True, 2), (100, True, 2)])
    def test_grads_match_jax(self, T, causal, groups):
        q, k, v = qkv(20, 1, T, 4, 4 // groups, 16)
        gj = jax.grad(
            lambda *a: jnp.sum(jax_flash(*a, causal=causal) ** 2),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        ts = [t(a, True) for a in (q, k, v)]
        (flash_attention(*ts, causal=causal) ** 2).sum().backward()
        assert ts[1].grad.shape == k.shape
        for a, b in zip(ts, gj):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)

    @pytest.mark.parametrize("with_out", [True, False])  # False: g_out None
    def test_flash_with_lse_cotangent_matches_jax(self, with_out):
        check_flash_with_lse(with_out)


def check_flash_with_lse(with_out):
    """flash_with_lse's (out, lse) and grads under an lse cotangent (and an
    out cotangent, or none), against JAX's."""
    BH, T, D, group = 4, 128, 16, 2
    q = randn(30, BH, T, D)
    k, v = randn(31, BH // group, T, D), randn(32, BH // group, T, D)
    g_out, g_lse = randn(33, BH, T, D) * with_out, randn(34, BH, 1, T)
    scale = D ** -0.5

    def jloss(q, k, v):
        out, lse = jax_flash_with_lse(q, k, v, scale, True, 128, 128, True)
        return jnp.sum(out * g_out) + jnp.sum(lse * g_lse), (out, lse)

    (_, (jout, jlse)), gj = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    ts = [t(a, True) for a in (q, k, v)]
    out, lse = flash_with_lse(*ts, scale, True)
    assert lse.shape == (BH, 1, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **FWD)
    loss = (lse * t(g_lse)).sum()
    if with_out:
        loss = loss + (out * t(g_out)).sum()
    loss.backward()
    for a, b in zip(ts, gj):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)


@pytest.fixture()
def two_kernel_route(monkeypatch):
    """Both packages' backward forced onto the two-kernel route (dq, then
    dk/dv), as tests/test_ops.py forces the JAX one; returns the names of
    the port's plain versions as they run."""
    monkeypatch.setattr(jax_fa, "_FUSED_DQ_VMEM_BYTES", 0)
    monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    ran = []

    def counted(name):
        fn = getattr(fa, name)

        def wrapper(*args):
            ran.append(name)
            return fn(*args)
        return wrapper

    for name in ("_flash_bwd_dq_reference", "_flash_bwd_dkv_reference"):
        monkeypatch.setattr(fa, name, counted(name))

    def fused(*args):
        raise AssertionError("the fused backward ran")

    monkeypatch.setattr(fa, "_flash_bwd_reference", fused)
    return ran


class TestTwoKernelRoute:
    """The JAX long-T backward (_bwd_dq_kernel then _bwd_dkv_kernel) and
    the port's (flash_bwd_dq / flash_bwd_dkv, plain versions here)."""

    @pytest.mark.parametrize("T,causal,groups", [
        (384, True, 1), (256, False, 1), (384, True, 2), (200, False, 2)])
    def test_grads_match_jax_twokernel(self, two_kernel_route, T, causal,
                                       groups):
        q, k, v = qkv(50, 1, T, 2 * groups, 2, 32)
        gj = jax.grad(
            lambda *a: jnp.sum(jax_flash(*a, causal=causal) ** 2),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        ts = [t(a, True) for a in (q, k, v)]
        (flash_attention(*ts, causal=causal) ** 2).sum().backward()
        assert two_kernel_route == ["_flash_bwd_dq_reference",
                                    "_flash_bwd_dkv_reference"]
        for a, b in zip(ts, gj):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)

    @pytest.mark.parametrize("D,T", [(64, 333), (128, 200)])
    def test_grads_match_jax_twokernel_hopper_dims(self, two_kernel_route,
                                                    D, T):
        """At the head dims the Hopper B3 / B4 take on the card (64, 128):
        GQA 2, causal, T not a multiple of any tile."""
        q, k, v = qkv(51, 1, T, 4, 2, D)
        gj = jax.grad(
            lambda *a: jnp.sum(jax_flash(*a, causal=True) ** 2),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        ts = [t(a, True) for a in (q, k, v)]
        (flash_attention(*ts, causal=True) ** 2).sum().backward()
        assert two_kernel_route == ["_flash_bwd_dq_reference",
                                    "_flash_bwd_dkv_reference"]
        for a, b in zip(ts, gj):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)

    @pytest.mark.parametrize("with_out", [True, False])
    def test_flash_with_lse_cotangent_twokernel(self, two_kernel_route,
                                                with_out):
        check_flash_with_lse(with_out)
        assert two_kernel_route == ["_flash_bwd_dq_reference",
                                    "_flash_bwd_dkv_reference"]

    @pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
    def test_route_rule_matches_jax(self, D):
        """The same (T, D) take the same backward in both packages: JAX
        decides on T padded to its block, the port (which pads nothing) on
        T itself."""
        for T in (1, 100, 1000, 1024, 4096, 8000, 8191, 8192, 8193, 9000,
                  16384, 16385, 32768, 40000, 65536, 65537):
            b = _auto_block(T, D)
            t_pad = -(-T // b) * b
            want = jax_fa._use_fused_bwd(t_pad, D, b, b)
            assert fa._use_fused_bwd(T, D) == want, (T, D)
        assert fa._FUSED_DQ_BYTES == jax_fa._FUSED_DQ_VMEM_BYTES


def hopper_by_the_rule(kernel, dtype, D):
    """The stated route, written out: the fused backward and the dk / dv
    kernel (the Hopper walk) run their Hopper versions for bf16 and fp16
    at kernel head dim 16, 32, 64, 128 or 256 and for f32 at 64, 128 or
    256; the forward and the dq kernel for bf16, fp16 and f32 at 64, 128
    or 256; everything else (D 16/32) runs WMMA."""
    if kernel in ("bwd", "dkv") and dtype != torch.float32:
        return D in (16, 32, 64, 128, 256)
    return D in (64, 128, 256)


class TestHopperDispatch:
    """Which version of each flash kernel a CUDA call launches, by the
    per-kernel, per-dtype rule (``_sm90``): the Hopper ones at D
    64/128/256 for every dtype, and the fused and dk / dv kernels at
    16-bit D 16/32 too; the WMMA ones elsewhere."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                       torch.float16])
    @pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
    def test_sm90_rule(self, dtype, D):
        for kernel in ("fwd", "bwd", "dq", "dkv"):
            want = hopper_by_the_rule(kernel, dtype, D)
            assert fa._sm90(kernel, dtype, D) is want, kernel

    def test_tiny_llama_backward_is_hopper(self):
        """At the head dim of ``llama.tiny()`` (16) in bf16, the fused
        backward and the dk / dv kernel take the Hopper walk, the forward
        and the dq kernel the WMMA versions; in f32 all four WMMA."""
        from pytorch_operator_tpu_torch.models import llama

        cfg = llama.tiny(dtype=torch.bfloat16)
        D = fa._kernel_dim(cfg.head_dim)
        assert D == 16
        assert {k: fa._sm90(k, torch.bfloat16, D)
                for k in ("fwd", "bwd", "dq", "dkv")} == {
            "fwd": False, "bwd": True, "dq": False, "dkv": True}
        assert not any(fa._sm90(k, torch.float32, D)
                       for k in ("fwd", "bwd", "dq", "dkv"))

    @pytest.mark.parametrize("D", [64, 128])
    def test_cpu_tensors_take_the_plain_versions(self, monkeypatch, D):
        """bf16 at D 64/128 would take the Hopper kernels on the card; CPU
        tensors of that kind run the plain versions, build and launch
        nothing, and agree with the f32 plain path to bf16's rounding."""
        def refuse():
            raise AssertionError("a CPU call built or loaded the kernels")

        monkeypatch.setattr(kernels, "build", refuse)
        monkeypatch.setattr(kernels, "load", refuse)
        ran = []

        def counted(name):
            fn = getattr(fa, name)

            def wrapper(*args):
                ran.append(name)
                return fn(*args)
            return wrapper

        for name in ("_flash_fwd_reference", "_flash_bwd_reference"):
            monkeypatch.setattr(fa, name, counted(name))
        before = kernels.launch_counts()
        q, k, v = qkv(60, 1, 96, 4, 2, D)
        g = randn(63, 1, 96, 4, D)
        grads = {}
        for dtype in (torch.bfloat16, torch.float32):
            ts = [t(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
            out = flash_attention(*ts, causal=True)
            out.backward(t(g).to(dtype))
            grads[dtype] = [out] + [x.grad for x in ts]
        assert ran == ["_flash_fwd_reference", "_flash_bwd_reference"] * 2
        assert kernels.launch_counts() == before
        assert kernels._lib is None
        for a, b in zip(grads[torch.bfloat16], grads[torch.float32]):
            assert a.dtype == torch.bfloat16
            err = (a.float() - b.detach()).abs().max().item()
            assert err <= 2e-2 * b.abs().max().item(), err


class TestTwoKernelDispatch:
    """Which kernel each wrapper launches (the forward, the fused backward,
    the dq and the dk / dv kernel): its Hopper version where the
    per-kernel rule takes it (every dtype at D 64/128/256, the fused and
    dk / dv kernels at 16-bit D 16/32 too), else its WMMA version."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                       torch.float16])
    @pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
    def test_wrappers_pick_by_the_rule(self, monkeypatch, dtype, D):
        picked = []
        monkeypatch.setattr(fa, "_checked_inputs",
                            lambda q, k, bh, tensors: (fa._dims(q, k, bh),
                                                       tensors))
        monkeypatch.setattr(fa, "_launch",
                            lambda kernel, *a: picked.append(kernel))
        q = torch.zeros(1, 8, 2, D, dtype=dtype)
        lse = torch.zeros(2, 8)
        args = (q, q, q, q, lse, lse, D ** -0.5, True, False)
        out, _ = fa._flash_fwd_cuda(*args[:3], D ** -0.5, True, False)
        fa._flash_bwd_cuda(*args)
        dq = fa._flash_bwd_dq_cuda(*args)
        dkp, dvp = fa._flash_bwd_dkv_cuda(*args)
        want = [(fa.FWD_SM90_KERNEL, fa.FWD_KERNEL),
                (fa.BWD_SM90_KERNEL, fa.BWD_KERNEL),
                (fa.BWD_DQ_SM90_KERNEL, fa.BWD_DQ_KERNEL),
                (fa.BWD_DKV_SM90_KERNEL, fa.BWD_DKV_KERNEL)]
        assert picked == [
            hopper if hopper_by_the_rule(kernel, dtype, D) else wmma
            for kernel, (hopper, wmma) in zip(("fwd", "bwd", "dq", "dkv"),
                                              want)]
        assert out.dtype == dq.dtype == dtype
        assert dkp.dtype == dvp.dtype == torch.float32
        # a kernel the caller names is the one launched
        fa._flash_bwd_dq_cuda(*args, kernel=fa.BWD_DQ_KERNEL)
        fa._flash_bwd_dkv_cuda(*args, kernel=fa.BWD_DKV_KERNEL)
        assert picked[4:] == [fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL]


class TestPlainVersions:
    """The backward kernel's plain version against autograd through the
    dense path (torch alone, f32)."""

    @pytest.mark.parametrize("causal,groups", [(True, 1), (False, 2)])
    def test_bwd_reference_matches_autograd(self, causal, groups):
        B, T, H, D = 2, 48, 4, 16
        q, k, v = (t(a, True) for a in qkv(40, B, T, H, H // groups, D))
        g = t(randn(43, B, T, H, D))
        scale = D ** -0.5
        _dense_path(q, k, v, scale, causal).backward(g)
        out, lse = _Flash.apply(q.detach(), k.detach(), v.detach(), scale,
                                causal, False)
        delta = (g * out).sum(-1).transpose(1, 2).reshape(B * H, T)
        dq, dkp, dvp = _flash_bwd_reference(
            q.detach(), k.detach(), v.detach(), g, lse.reshape(B * H, T),
            delta, scale, causal, False)
        dk = dkp.view(B, T, H // groups, groups, D).sum(3)
        dv = dvp.view(B, T, H // groups, groups, D).sum(3)
        for a, b in zip((dq, dk, dv), (q.grad, k.grad, v.grad)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
        # the two-kernel route's plain versions: the same dq (in q's
        # dtype) and the same per-q-head partials
        args = (q.detach(), k.detach(), v.detach(), g,
                lse.reshape(B * H, T), delta, scale, causal, False)
        dq2 = _flash_bwd_dq_reference(*args)
        assert dq2.dtype == q.dtype
        torch.testing.assert_close(dq2, dq, atol=0, rtol=0)
        for a, b in zip(_flash_bwd_dkv_reference(*args), (dkp, dvp)):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
