"""The port's RMSNorm against the JAX ``rms_norm`` in every pair of x and
weight dtypes, on the CPU.

Both take x in float32, bfloat16 or float16 with a weight in any of the
three, compute in f32 and return x's dtype.  The inputs are made in f32
with a numpy seed and cast in each framework (both round to nearest
even).  On the card ``tests/test_torch_cuda.py`` holds the kernel against
the plain version these tests hold against JAX.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.ops import rms_norm as jax_rms_norm
from pytorch_operator_tpu_torch.ops import rms_norm

rn = importlib.import_module("pytorch_operator_tpu_torch.ops.rms_norm")

# tests/test_ops.py's gradient tolerance, as tests/test_torch_ops.py
GRAD = dict(atol=5e-5, rtol=1e-3)
# one ulp of a 16-bit output dtype, relative to |ref|: the same f32 math
# on both sides, the sum of squares taken in another order.  An f32
# output shows that math's own difference: XLA's rsqrt and mean against
# torch's put the two up to 2.6 ulps apart (3.1e-7 relative), so f32
# takes four (2^-21)
ULP = {"float32": 2.0 ** -21, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
PAIRS = [("float16", "float16"), ("bfloat16", "float32"),
         ("float32", "bfloat16"), ("float16", "float32"),
         ("bfloat16", "bfloat16"), ("float32", "float32")]


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def both(a, dtype):
    """``a`` cast to ``dtype`` in JAX and in torch."""
    return jnp.asarray(a).astype(dtype), torch.tensor(a).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("xdtype,wdtype", PAIRS)
@pytest.mark.parametrize("shape", [(128, 64), (7, 3, 64)])
def test_forward_matches_jax(shape, xdtype, wdtype):
    # (128, 64) takes the JAX Pallas kernel in interpret mode (rows % 64
    # == 0), the ragged (7, 3, 64) the JAX jnp path
    (xj, xt), (wj, wt) = (both(randn(0, *shape), xdtype),
                          both(randn(1, shape[-1]) + 1.0, wdtype))
    ref = jax_rms_norm(xj, wj, block_rows=64)
    out = rms_norm(xt, wt)
    assert str(ref.dtype) == xdtype
    assert out.dtype == getattr(torch, xdtype)
    ref32 = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref32)
    assert (err <= ULP[xdtype] * np.abs(ref32)).all(), err.max()


def test_fp16_grads_match_jax():
    x, w = randn(2, 128, 64), randn(3, 64) + 1.0
    (xj, xt), (wj, wt) = both(x, "float16"), both(w, "float16")
    gj = jax.grad(
        lambda x, w: jnp.sum(jnp.sin(
            jax_rms_norm(x, w, block_rows=64).astype(jnp.float32))),
        argnums=(0, 1))(xj, wj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    torch.sin(rms_norm(xt, wt).float()).sum().backward()
    for a, b in zip((xt.grad, wt.grad), gj):
        assert a.dtype == torch.float16 and str(b.dtype) == "float16"
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)), **GRAD)


class TestWrapperContract:
    """What ``rms_norm_cuda`` takes, on CPU tensors: the dtype check comes
    first, then the device."""

    @pytest.mark.parametrize("xdtype,wdtype", [
        (torch.float64, torch.bfloat16), (torch.bfloat16, torch.float64),
        (torch.float64, torch.float64)])
    def test_f64_is_refused(self, xdtype, wdtype):
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            rn.rms_norm_cuda(torch.ones(4, 8, dtype=xdtype),
                             torch.ones(8, dtype=wdtype), 1e-5)

    @pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32,
                                        torch.float16])
    def test_fp16_with_any_weight_is_refused_only_for_the_device(self,
                                                                 wdtype):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            rn.rms_norm_cuda(torch.ones(4, 8, dtype=torch.float16),
                             torch.ones(8, dtype=wdtype), 1e-5)

    def test_the_yardstick_takes_a_weight_in_xs_dtype_only(self):
        with pytest.raises(ValueError, match="in x's dtype"):
            rn.rms_norm_cuda(torch.ones(4, 8).bfloat16(), torch.ones(8),
                             1e-5, kernel=rn.ROWBLOCK_KERNEL)

    def test_weight_shape(self):
        with pytest.raises(ValueError, match=r"weight must be \(8,\)"):
            rn.rms_norm_cuda(torch.ones(4, 8).half(), torch.ones(7).half(),
                             1e-5)
