"""The port's sequence-parallel step with tensor parallelism, and under a
remat tier with FSDP2, against the JAX step, on the CPU.

As ``tests/test_torch_sp_train.py``, on four gloo ranks: (dp, fsdp, sp,
tp) = (1, 1, 2, 2), where each tp rank runs the ring or the all-to-all on
its own heads (with JAX's ``param_specs``, the fsdp x tp layout), and
(1, 2, 2, 1) under ``save_attn+qkv``, whose recompute runs the ring's
transfers again inside FSDP2's hooks.
"""

from test_torch_sp_train import IMPLS, run_sp_step


def test_sp2_tp2(tmp_path):
    """SP x TP: q/k/v column-sharded over tp, two q heads and one kv head
    per tp rank; ulysses repeats that kv head to lcm(1, 2) = 2."""
    res = run_sp_step(tmp_path, (1, 1, 2, 2), B=2, chunked_ce=False)
    assert all(r["dtensor"] for r in res.values())


def test_fsdp2_sp2_under_save_attn(tmp_path):
    """The remat tier save_attn+qkv (flash (out, lse) kept: on the ring,
    each chunk's) over FSDP2 and sp: the values of the JAX step without
    remat, as remat changes none."""
    run_sp_step(tmp_path, (1, 2, 2, 1), B=2, chunked_ce=True, impls=IMPLS,
                remat_policy="save_attn+qkv")
