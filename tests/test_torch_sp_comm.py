"""The port's sequence-parallel communication on gloo ranks, on the CPU.

The P2P ring (``RingComm``, ``batch_isend_irecv``) on n gloo processes
(``tests/torch_dist_workers.py``) against the loopback ring, bit for bit;
Ulysses (``parallel/ulysses.py``, through the model's ``sp_attention``
with its minimal kv repeat) on gloo ranks against JAX
``ulysses_attention`` on the host devices ``tests/conftest.py`` forces.
Inputs are numpy-seeded f32; the tolerances are
``tests/test_parallel.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_workers as workers
from pytorch_operator_tpu.parallel import make_sp_mesh as jax_make_sp_mesh
from pytorch_operator_tpu.parallel.ring_attention import (
    zigzag_layout as jax_zigzag_layout,
)
from pytorch_operator_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses,
)
from test_torch_sp_ring import _assert_close, _inputs, _jax_vjp


def _ring_case_arrays(sp):
    arrays = {}
    for name, layout, causal, Hk in (("contiguous", "contiguous", True, 2),
                                     ("noncausal", "contiguous", False, 4),
                                     ("zigzag", "zigzag_pre", True, 2)):
        q, k, v, g = _inputs(sp, 2, 8 * sp, 4, Hk, 16)
        arrays.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v,
                       f"{name}/g": g, f"{name}/layout": np.array(layout),
                       f"{name}/causal": np.array(causal),
                       f"{name}/perm": jax_zigzag_layout(8 * sp, sp)[0]})
    return arrays


@pytest.mark.parametrize("sp", [2, 4])
def test_p2p_ring_is_the_loopback_bit_for_bit(sp, tmp_path):
    """sp gloo ranks, each its chunk through batch_isend_irecv, give the
    loopback's out and grads bit for bit: the same arithmetic in the same
    order, only the transport differs."""
    np.savez(tmp_path / "in.npz", **_ring_case_arrays(sp))
    out = str(tmp_path / "out")
    workers.spawn(workers.ring_worker, sp, str(tmp_path / "in.npz"), out,
                  timeout=120)
    ranks = [np.load(f"{out}.{r}.npz") for r in range(sp)]
    for case in ("contiguous", "noncausal", "zigzag"):
        for name in ("out", "dq", "dk", "dv"):
            whole = ranks[0][f"{case}/loopback/{name}"]
            parts = np.split(whole, sp, axis=1)
            for r in range(sp):
                np.testing.assert_array_equal(
                    ranks[r][f"{case}/p2p/{name}"], parts[r],
                    err_msg=f"{case} {name} rank {r}")


@pytest.mark.parametrize("sp,cases", [
    (2, [("h4kv2", 4, 2, False), ("h4kv4_flash", 4, 4, True)]),
    (4, [("h4kv2_repeat", 4, 2, True), ("h8kv8", 8, 8, False)])])
def test_ulysses_on_gloo_matches_jax(sp, cases, tmp_path):
    """Ulysses on sp gloo ranks against JAX ulysses_attention on an sp
    mesh; where kv heads do not divide sp (kv 2 over sp 4) the model's
    attention repeats K/V to lcm(kv, sp) heads first, as the JAX
    forward_sp does, and the grads flow back through the repeat."""
    B, T, D = 2, 8 * sp, 16
    arrays, refs = {}, {}
    mesh = jax_make_sp_mesh(dp=8 // sp, sp=sp)
    for name, H, Hk, flash in cases:
        q, k, v, g = _inputs(sp * 100 + H, B, T, H, Hk, D)
        arrays.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v,
                       f"{name}/g": g, f"{name}/flash": np.array(flash)})
        r = np.lcm(Hk, sp) // Hk if Hk % sp else 1

        def fn(q, k, v, r=r, flash=flash):
            k, v = jnp.repeat(k, r, axis=2), jnp.repeat(v, r, axis=2)
            return jax_ulysses(q, k, v, mesh, use_flash=flash)

        refs[name] = _jax_vjp(fn, q, k, v, g)
    np.savez(tmp_path / "in.npz", **arrays)
    out = str(tmp_path / "out")
    workers.spawn(workers.ulysses_worker, sp, str(tmp_path / "in.npz"), out,
                  timeout=120)
    ranks = [np.load(f"{out}.{r}.npz") for r in range(sp)]
    for name, *_ in cases:
        got = [np.concatenate([ranks[r][f"{name}/{x}"] for r in range(sp)],
                              axis=1) for x in ("out", "dq", "dk", "dv")]
        _assert_close(got, refs[name])
