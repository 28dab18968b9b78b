"""Parity of the torch port's training step with the JAX step, on the CPU.

The JAX step (``parallel.train.make_train_step`` on a one-device mesh,
``optax.adamw``) and the port's step (``torch.optim.AdamW`` at the same
hyperparameters) start from the same ``init_params`` tree, carried into
the port by ``load_jax_params``, and take the same seeded token batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel import make_mesh, sharded_init
from pytorch_operator_tpu.parallel import make_train_step as jax_make_step
from pytorch_operator_tpu.parallel.train import (
    chunked_tied_ce as jax_chunked_tied_ce,
)
from pytorch_operator_tpu.parallel.train import (
    cross_entropy_loss as jax_cross_entropy,
)
from pytorch_operator_tpu_torch import train_llama
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    chunked_tied_ce,
    cross_entropy_loss,
    global_norm,
    make_train_step,
)

T, LR, WD = 32, 3e-4, 0.1


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def batches(n, B=2, vocab=512):
    return [np.random.default_rng(100 + i).integers(0, vocab, (B, T + 1))
            for i in range(n)]


def test_cross_entropy_matches_jax():
    logits, targets = randn(0, 2, 7, 50), np.random.default_rng(1).integers(
        0, 50, (2, 7))
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    out = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(targets))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("chunk", [8, 12, 64])  # even, ragged, one chunk
def test_chunked_tied_ce_matches_jax_and_full_ce(chunk):
    h, embed = randn(2, 2, 24, 16), randn(3, 40, 16)
    targets = np.random.default_rng(4).integers(0, 40, (2, 24))
    jl, jg = jax.value_and_grad(jax_chunked_tied_ce, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(embed), jnp.asarray(targets), chunk)
    ht, et = (torch.tensor(a, requires_grad=True) for a in (h, embed))
    tt = torch.from_numpy(targets)
    loss = chunked_tied_ce(ht, et, tt, chunk)
    full = cross_entropy_loss(ht.detach() @ et.detach().t(), tt)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), full.item(), rtol=1e-6)
    loss.backward()
    for a, b in zip((ht.grad, et.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)


def test_global_norm_matches_optax():
    grads = [randn(5, 3, 4), randn(6, 7), randn(7, 2, 2, 2)]
    ref = optax.global_norm([jnp.asarray(g) for g in grads])
    out = global_norm(torch.from_numpy(g) for g in grads)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("kernels,chunked_ce", [(True, False),
                                                (False, True)])
def test_two_adamw_steps_match_jax(kernels, chunked_ce):
    flags = dict(use_flash=kernels, use_fused_norm=kernels, max_seq_len=T)
    jcfg, tcfg = jllama.tiny(**flags), llama.tiny(**flags)
    opt = optax.adamw(LR, weight_decay=WD)
    jstate = sharded_init(jcfg, make_mesh(1, 1, 1), opt, seed=11)
    tree = jax.tree.map(np.asarray, jstate.params)  # before donation
    jstep = jax_make_step(jcfg, make_mesh(1, 1, 1), opt,
                          chunked_ce=chunked_ce, ce_chunk=12)

    model = llama.load_jax_params(llama.Llama(tcfg, device="cpu"), tree)
    optimizer = adamw(model, LR, weight_decay=WD)
    state = TrainState(model, optimizer)
    step = make_train_step(tcfg, model, optimizer, chunked_ce=chunked_ce,
                           ce_chunk=12)
    for batch in batches(2):
        jstate, jm = jstep(jstate, jnp.asarray(batch))
        state, m = step(state, batch)
        # first step: the f32 forward/backward tolerance of the logits;
        # second step: Adam's first update is ~lr * sign(g) per element,
        # so a gradient entry near 0 whose sign differs between the two
        # frameworks' summation orders moves by 2 lr -- hence 1e-4
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 2


def test_adamw_is_optax_adamw():
    """One update of a lone parameter, bf16 moments included."""
    p0, g = randn(8, 16), randn(9, 16)
    opt = optax.adamw(LR, weight_decay=WD)
    jp = jnp.asarray(p0)
    st = opt.init(jp)
    upd, st = opt.update(jnp.asarray(g), st, jp)
    want = np.asarray(optax.apply_updates(jp, upd))
    model = torch.nn.Linear(16, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0)[None])
    o = adamw(model, LR, weight_decay=WD)
    model.weight.grad = torch.from_numpy(g)[None]
    o.step()
    np.testing.assert_allclose(model.weight.detach().numpy()[0], want,
                               atol=1e-7, rtol=1e-6)


def test_step_rejects_a_foreign_state():
    cfg = llama.tiny(n_layers=1)
    model = llama.Llama(cfg, device="cpu")
    other = llama.Llama(cfg, device="cpu")
    step = make_train_step(cfg, model, adamw(model))
    with pytest.raises(ValueError):
        step(TrainState(other, adamw(other)), batches(1)[0])
    with pytest.raises(ValueError):
        make_train_step(cfg, model, adamw(model), ce_chunk=0)
    with pytest.raises(ValueError):
        make_train_step(llama.tiny(n_layers=2), model, adamw(model))


class TestTrainLlamaEntry:
    def test_tiny_run_on_cpu(self, capsys):
        rc = train_llama.main(["--model", "tiny", "--device", "cpu",
                               "--steps", "2", "--batch-size", "2",
                               "--seq-len", "16", "--log-interval", "1"])
        out = capsys.readouterr().out
        assert rc == 0 and "training complete" in out
        assert out.count("loss=") == 2
        assert "flash=False fused_norm=False remat=True" in out

    @pytest.mark.parametrize("argv,flash,norm,remat", [
        ([], True, True, False),
        (["--no-flash", "--remat"], False, True, True),
        (["--no-fused-norm"], True, False, False)])
    def test_kernels_default_on_for_cuda(self, argv, flash, norm, remat):
        args = train_llama.parse_args(["--model", "flagship", *argv])
        cfg = train_llama.build_config(args, torch.device("cuda"))
        assert (cfg.use_flash, cfg.use_fused_norm, cfg.remat) == (
            flash, norm, remat)
        cpu = train_llama.build_config(
            train_llama.parse_args(["--model", "tiny"]), torch.device("cpu"))
        assert not cpu.use_flash and not cpu.use_fused_norm and cpu.remat

    @pytest.mark.parametrize("flag", ["--dp", "--fsdp", "--tp", "--pp",
                                      "--sp"])
    def test_parallel_flags_not_accepted(self, flag):
        """--dp/--fsdp/--tp alone are refused; --pp and --sp are ported
        (their checks: tests/test_torch_pp_cli.py, _sp_cli.py), and --pp
        2 is refused on one process and --sp beside --pp, as the JAX
        entry refuses them."""
        argv = [flag, "2"] + (["--pp", "2"] if flag == "--sp" else [])
        with pytest.raises(SystemExit):
            args = train_llama.parse_args(argv)
            train_llama.pp_stages(args, 1, train_llama.MODELS[args.model]())

    def test_flagship_config(self):
        cfg = train_llama.build_config(
            train_llama.parse_args(["--model", "flagship", "--seq-len",
                                    "2048"]), torch.device("cuda"))
        want = dict(dim=2048, n_layers=16, n_heads=16, n_kv_heads=16,
                    ffn_dim=5632, vocab_size=32000, dtype=torch.bfloat16)
        assert {k: getattr(cfg, k) for k in want} == want
        assert dataclasses.replace(cfg, max_seq_len=2048) == cfg


class TestRematPolicyFlag:
    """--remat-policy: the JAX entry's checks and its ``auto``."""

    @pytest.mark.parametrize("argv", [
        ["--remat-policy", "bogus"],
        ["--remat-policy", "nothing_saveable"],
        ["--remat-policy", "save_attn+bogus", "--flash"],
        ["--model", "flagship", "--remat-policy", "save_attn"],
        ["--no-remat", "--remat-policy", "dots_saveable"],
        ["--remat-policy", "save_attn", "--device", "cpu"],
        ["--remat-policy", "auto", "--no-flash"]])
    def test_rejected(self, argv):
        with pytest.raises(SystemExit):
            train_llama.parse_args(argv)

    @pytest.mark.parametrize("policy", [
        "save_attn", "save_attn+qkv", "save_attn+gateup+normed",
        "dots_saveable", "dots_with_no_batch_dims_saveable"])
    def test_taken_as_given(self, policy):
        args = train_llama.parse_args(["--remat-policy", policy])
        cfg = train_llama.build_config(args, torch.device("cuda"))
        assert cfg.remat and cfg.remat_policy == policy

    def test_long_context_command(self):
        args = train_llama.parse_args(
            ["--model", "flagship", "--batch-size", "1", "--seq-len",
             "16384", "--remat", "--remat-policy", "save_attn+qkv",
             "--chunked-ce"])
        cfg = train_llama.build_config(args, torch.device("cuda"))
        assert (cfg.remat, cfg.remat_policy, cfg.use_flash,
                cfg.max_seq_len) == (True, "save_attn+qkv", True, 16384)
        assert args.chunked_ce and args.ce_chunk == 1024

    @pytest.mark.parametrize("total_gib,want", [
        (80, "save_attn+qkv+gateup+normed"), (16, "save_attn+gateup")])
    def test_auto_takes_the_card_memory(self, monkeypatch, capsys,
                                        total_gib, want):
        class Props:
            total_memory = total_gib * 2 ** 30

        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: Props)
        args = train_llama.parse_args(
            ["--model", "flagship", "--batch-size", "1", "--seq-len",
             "16384", "--remat", "--remat-policy", "auto"])
        cfg = train_llama.build_config(args, torch.device("cuda"))
        assert cfg.remat_policy == want == llama.auto_remat_policy(
            cfg, 1, 16384, hbm_gb=total_gib)
        assert f"--remat-policy auto -> {want}" in capsys.readouterr().out

    def test_tiny_run_with_a_tier_on_cpu(self, capsys):
        rc = train_llama.main(["--model", "tiny", "--device", "cpu",
                               "--flash", "--remat-policy", "auto",
                               "--steps", "2", "--batch-size", "2",
                               "--seq-len", "16", "--log-interval", "1"])
        out = capsys.readouterr().out
        assert rc == 0 and "training complete" in out
        assert "remat_policy=save_attn+qkv+gateup+normed" in out
