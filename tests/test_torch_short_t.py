"""The short-T forward-only dispatch against the JAX package, on the CPU.

The JAX ``flash_attention`` sends a forward-only call with default
blocks at T <= ``_DENSE_FWD_MAX_T`` (1024) to dense XLA
(``_route_small_t``: ``jax.custom_vjp`` runs ``_dense_path`` as the
undifferentiated primal, flash under ``grad``).  The port has no such
route: timed on the H100 (``chip_smoke.py`` phase 3,
``short_t_forward``), B1 beat the port's ``_dense_path`` at every T from
128 to 2048, so every call runs ``flash_fwd``.  These tests pin that
divergence: at each T the port calls ``flash_fwd`` and never
``_dense_path``, the JAX module calls ``_dense_path`` exactly where its
rule says, and the outputs (and gradients) agree at
``tests/test_ops.py``'s tolerances.

The JAX side runs without ``jit``, so its Python ``_dense_path`` runs
when it is called (at trace time, under ``lax.scan``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_pp_train_step,
)

jax_fa = importlib.import_module("pytorch_operator_tpu.ops.flash_attention")
fa = importlib.import_module("pytorch_operator_tpu_torch.ops.flash_attention")

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-3)
LOGITS = dict(atol=2e-4, rtol=1e-3)
JAX_MAX_T = jax_fa._DENSE_FWD_MAX_T  # 1024, TPU-tuned


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class Spy:
    """Counts the calls of a module function and passes them through."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def spy(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, spy)


@pytest.fixture()
def spies(monkeypatch):
    return {"port_flash": Spy(monkeypatch, fa, "flash_fwd"),
            "port_dense": Spy(monkeypatch, fa, "_dense_path"),
            "jax_dense": Spy(monkeypatch, jax_fa, "_dense_path")}


def qkv(seed, T, H=2, Hk=2, D=16, B=1):
    return (randn(seed, B, T, H, D), randn(seed + 1, B, T, Hk, D),
            randn(seed + 2, B, T, Hk, D))


def port_forward(q, k, v, mode):
    """The port's flash_attention on CPU tensors: under no_grad
    ("no_grad"), with grad enabled on inputs that take none ("plain"),
    or on inputs that take grads ("grad")."""
    ts = [torch.tensor(x, requires_grad=mode == "grad") for x in (q, k, v)]
    with torch.set_grad_enabled(mode != "no_grad"):
        return fa.flash_attention(*ts), ts


# T = 1, a tile's tail (96, 100), the pipeline's 256, the JAX limit and
# one past it
SHORT_T = (1, 96, 100, 256, 1024, 1025)
MODES = ("no_grad", "plain", "grad")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T", SHORT_T)
def test_port_runs_flash_where_jax_runs_dense(spies, T, mode):
    q, k, v = qkv(T, T, H=2, Hk=2, D=16)
    out, ts = port_forward(q, k, v, mode)
    # the port: flash_fwd at every T and in every mode, never dense
    assert spies["port_flash"].calls == 1
    assert spies["port_dense"].calls == 0
    assert out.requires_grad == (mode == "grad")
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    if mode == "grad":
        ref, vjp = jax.vjp(jax_fa.flash_attention, qj, kj, vj)
    else:
        ref = jax_fa.flash_attention(qj, kj, vj)
    # JAX: dense exactly for a forward-only call at T <= 1024
    jax_dense = mode != "grad" and T <= JAX_MAX_T
    assert (spies["jax_dense"].calls > 0) == jax_dense
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    if mode == "grad":
        g = randn(7, *q.shape)
        out.backward(torch.tensor(g))
        for got, want in zip(ts, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                       **GRAD)


@pytest.mark.parametrize("T", (128, 256))
def test_gqa_forward_only_matches_jax_route_small_t(spies, T):
    # llama.tiny's heads (8 over 4 kv heads, D 16) through JAX's
    # _route_small_t (dense) and the port's B1 plain version
    q, k, v = qkv(40 + T, T, H=8, Hk=4, D=16, B=2)
    out, _ = port_forward(q, k, v, "no_grad")
    ref = jax_fa._route_small_t(*map(jnp.asarray, (q, k, v)), 16 ** -0.5,
                                True, jax_fa._auto_block(T, 16), True)
    assert spies["jax_dense"].calls == 1
    assert (spies["port_flash"].calls, spies["port_dense"].calls) == (1, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    # the port's own _dense_path (the phase-3 yardstick) agrees with both
    dense = fa._dense_path(*(torch.tensor(x) for x in (q, k, v)),
                           16 ** -0.5, True)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("causal", (True, False))
def test_non_causal_forward_only(spies, causal):
    q, k, v = qkv(60, 200, H=4, Hk=2, D=32)
    with torch.no_grad():
        out = fa.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                                 causal=causal)
    ref = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                 causal=causal)
    assert spies["jax_dense"].calls > 0
    assert (spies["port_flash"].calls, spies["port_dense"].calls) == (1, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


def test_llama_inference_runs_flash_per_layer(spies):
    # llama.forward under no_grad at T 64 (tests/test_torch_llama.py's
    # call): the port launches B1's plain version once a layer; the JAX
    # model's layers (one lax.scan body) run dense
    jcfg = jllama.tiny(use_flash=True, use_fused_norm=True, max_seq_len=64)
    cfg = llama.tiny(use_flash=True, use_fused_norm=True, max_seq_len=64)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = llama.load_jax_params(llama.Llama(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(1).integers(0, 512, (2, 64))
    ref = jllama.forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        out = llama.forward(model, torch.from_numpy(toks))
    assert spies["port_flash"].calls == cfg.n_layers
    assert spies["port_dense"].calls == 0
    assert spies["jax_dense"].calls > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGITS)


@pytest.mark.parametrize("schedule", ("gpipe", "1f1b"))
def test_pipeline_forward_tick_runs_flash(spies, schedule):
    # the loopback pipeline at T 32: 1F1B's forward tick of stages
    # 0..S-2 runs under no_grad, where the JAX stage (do_f, outside any
    # vjp) runs dense; the port calls flash_fwd there and again on the
    # backward tick, as chip_smoke.pp_launches counts B1 at T4096
    L, S, M = 4, 2, 2
    cfg = llama.tiny(n_layers=L, use_flash=True, max_seq_len=32)
    stages = llama.pipeline_stages(cfg, S, device="cpu")
    opt = adamw(stages, 3e-4, weight_decay=0.1)
    step = make_pp_train_step(cfg, stages, opt, n_microbatches=M,
                              schedule=schedule)
    batch = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 33)))
    _, metrics = step(TrainState(stages, opt), batch)
    assert np.isfinite(float(metrics["loss"]))
    runs = [2 if schedule == "1f1b" and s < S - 1 else 1 for s in range(S)]
    assert spies["port_flash"].calls == M * (L // S) * sum(runs)
    assert spies["port_dense"].calls == 0


def test_port_has_no_short_t_route():
    # the H100 sweep found no T at which dense wins, so the port carries
    # neither the JAX constant nor a router
    assert not hasattr(fa, "_DENSE_FWD_MAX_T")
    assert not hasattr(fa, "_route_small_t")
