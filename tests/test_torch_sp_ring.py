"""The port's sequence-parallel attention against the JAX package, on the
CPU.

The ring (``parallel/ring_attention.py``) runs as n virtual ranks in this
process (the loopback) against JAX ``ring_attention`` on the host devices
``tests/conftest.py`` forces (``tests/test_torch_sp_comm.py`` holds the
gloo ranks).  Inputs are numpy-seeded f32; the tolerances are
``tests/test_parallel.py``'s.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.parallel import make_sp_mesh as jax_make_sp_mesh
from pytorch_operator_tpu.parallel import ring_attention as jax_ring
from pytorch_operator_tpu.parallel.ring_attention import (
    zigzag_layout as jax_zigzag_layout,
)

# the module (parallel/__init__ re-exports a function of the same name)
ring = importlib.import_module(
    "pytorch_operator_tpu_torch.parallel.ring_attention")

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


def _inputs(seed, B, T, H, Hk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, D), (B, T, Hk, D), (B, T, Hk, D),
                      (B, T, H, D))]


def _jax_vjp(fn, q, k, v, g):
    """out and the grads of q, k, v of ``fn`` for the cotangent g, in one
    jitted call (compiled once, not dispatched op by op)."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))

    return [np.asarray(x) for x in run(*(jnp.asarray(x)
                                         for x in (q, k, v, g)))]


def _port(fn, q, k, v, g):
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    out.backward(torch.from_numpy(g))
    return [t.detach().numpy() for t in (out, *(x.grad for x in xs))]


def _assert_close(got, want):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name,
                                   **(OUT_TOL if name == "out" else GRAD_TOL))


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("layout,causal,H,Hk", [
    ("contiguous", True, 4, 4), ("contiguous", False, 4, 4),
    ("zigzag", True, 4, 4), ("zigzag_pre", True, 4, 4),
    ("contiguous", True, 4, 2), ("zigzag", True, 4, 2)],
    ids=["causal", "non-causal", "zigzag", "zigzag-pre", "gqa-h4-kv2",
         "zigzag-gqa"])
def test_loopback_ring_matches_jax(sp, layout, causal, H, Hk):
    """The loopback ring of sp virtual ranks against JAX ring_attention on
    an sp mesh: out and the grads of q, k and v (the port's written-out
    backward against JAX's autodiff through ppermute)."""
    B, T, D = 2, 8 * sp, 16
    q, k, v, g = _inputs(sp * 10 + Hk, B, T, H, Hk, D)
    mesh = jax_make_sp_mesh(dp=8 // sp, sp=sp)
    want = _jax_vjp(lambda *x: jax_ring(*x, mesh, causal=causal,
                                        layout=layout), q, k, v, g)
    got = _port(lambda *x: ring.ring_attention_loopback(
        *x, sp, causal=causal, layout=layout), q, k, v, g)
    _assert_close(got, want)


def test_zigzag_layout_matches_jax():
    for T, sp in ((16, 2), (64, 4), (24, 3)):
        for a, b in zip(ring.zigzag_layout(T, sp), jax_zigzag_layout(T, sp)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible by 2\\*sp=4"):
        ring.zigzag_layout(6, 2)


def test_ring_checks_match_jax():
    x = torch.zeros(1, 8, 4, 8)
    with pytest.raises(ValueError, match="kv heads must divide q heads"):
        ring.ring_attention_loopback(x, x[:, :, :3], x[:, :, :3], 2)
    with pytest.raises(ValueError, match="exists to balance CAUSAL"):
        ring.ring_attention_loopback(x, x, x, 2, causal=False,
                                     layout="zigzag")
    with pytest.raises(ValueError, match="unknown ring layout"):
        ring.ring_attention_loopback(x, x, x, 2, layout="spiral")


@pytest.mark.parametrize("n,layout,causal,want", [
    (4, "contiguous", True, 10), (4, "zigzag_pre", True, 36),
    (4, "contiguous", False, 16), (1, "contiguous", True, 1),
    (8, "zigzag_pre", True, 8 * 17)])
def test_chunk_pairs_per_ring(n, layout, causal, want):
    """Chunk pairs computed (one forward kernel and one backward route
    each): rank r of the contiguous causal ring r+1, of zigzag 2n+1."""
    assert ring.ring_launches(n, causal, layout) == want
