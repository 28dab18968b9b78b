"""The port's ResNet against the flax ResNet, on the CPU.

The JAX module (``pytorch_operator_tpu/models/resnet.py``) and the
port's (``pytorch_operator_tpu_torch/models/resnet.py``) take the same
weights, carried across by ``load_jax_params``, and the same seeded
numpy inputs.  Tolerances, in f32: each leaf's largest error at most
1e-4 of that leaf's largest magnitude (``close``); logits and losses
``rtol=1e-4``.  Each of the module's three departures from torchvision
has a test that fails if it is undone: lax's asymmetric ``SAME``
padding of the convs and of the max-pool, and flax's BatchNorm (its
biased running variance, its E[x^2] - E[x]^2 statistics clipped at 0).
The fourth, the global batch's statistics under data parallelism, is
``tests/test_torch_resnet_dist.py``'s.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_operator_tpu.models import resnet as jres
from pytorch_operator_tpu_torch import train_resnet
from pytorch_operator_tpu_torch.models import resnet

RTOL = 1e-4


def close(got, want, rel=RTOL, what=""):
    """max|got - want| <= rel * max|want| (a leaf's relative error)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rel * max(scale, 1e-12), (what, err, scale)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ----------------------------------------------------------------------
# SAME padding: the convs and the max-pool
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,k,s", [(8, 3, 2), (9, 3, 2), (8, 1, 2),
                                      (9, 1, 2), (8, 3, 1), (7, 3, 1),
                                      (112, 3, 2), (56, 3, 2)])
def test_same_pads_are_lax(size, k, s):
    lo, hi = resnet.same_pads(size, k, s)
    (want,) = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
    assert (lo, hi) == tuple(want)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("k,s", [(3, 2), (1, 2), (3, 1)])
def test_conv_matches_flax(size, k, s):
    rng = np.random.default_rng(size * 10 + k + s)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    conv = fnn.Conv(6, (k, k), (s, s), use_bias=False, dtype=jnp.float32)
    params = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    mine = resnet.Conv(5, 6, k, s, dtype=torch.float32, device="cpu")
    kernel = np.asarray(params["params"]["kernel"])
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        got = nhwc(mine(nchw(x)))
    close(got, want, what=f"conv {size} k{k} s{s}")


@pytest.mark.parametrize("size", [8, 9, 112])
def test_max_pool_matches_flax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    got = nhwc(resnet.max_pool_same(nchw(x)))
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# flax's BatchNorm
# ----------------------------------------------------------------------


def _bn_case(seed=0, C=6, constant=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 5, C)) * 2.0 + 3.0).astype(np.float32)
    x[..., 0] = constant  # a constant channel: E[x^2] - E[x]^2 near 0
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(C)).astype(np.float32)
    mean = (0.5 * rng.standard_normal(C)).astype(np.float32)
    var = (1.0 + np.abs(rng.standard_normal(C))).astype(np.float32)
    return x, g, scale, bias, mean, var


def _flax_bn(x, g, scale, bias, mean, var, train):
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y, new)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    return {"y": np.asarray(y), "dx": np.asarray(dx),
            "dscale": np.asarray(dp["scale"]), "dbias": np.asarray(dp["bias"]),
            "mean": np.asarray(new["mean"]), "var": np.asarray(new["var"])}


def _port_bn(x, g, scale, bias, mean, var, train):
    bn = resnet.FlaxBatchNorm(x.shape[-1], device="cpu").train(train)
    with torch.no_grad():
        for t, a in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean),
                     (bn.var, var)):
            t.copy_(torch.from_numpy(a))
    xt = nchw(x).requires_grad_(True)
    y = bn(xt)
    y.backward(nchw(g))
    return {"y": nhwc(y), "dx": nhwc(xt.grad),
            "dscale": bn.scale.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.mean.numpy(), "var": bn.var.numpy()}


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(train):
    case = _bn_case()
    want = _flax_bn(*case, train)
    got = _port_bn(*case, train)
    for name in want:
        close(got[name], want[name], what=f"{name} train={train}")
    if not train:  # eval leaves the running statistics as they were
        np.testing.assert_array_equal(got["mean"], case[4])
        np.testing.assert_array_equal(got["var"], case[5])


def test_running_variance_is_the_biased_one():
    """flax moves the running variance toward the batch's biased
    variance; PyTorch's BatchNorm toward n/(n-1) of it."""
    x, g, scale, bias, mean, var = _bn_case(1)
    got = _port_bn(x, g, scale, bias, mean, var, True)
    batch = x.reshape(-1, x.shape[-1]).astype(np.float64)
    n = batch.shape[0]
    biased = 0.9 * var + 0.1 * batch.var(0)
    unbiased = 0.9 * var + 0.1 * batch.var(0) * n / (n - 1)
    close(got["var"], biased, rel=1e-5)
    assert np.abs(got["var"] - unbiased).max() > 1e-3


def test_negative_variance_is_clipped_to_zero():
    """A constant channel whose E[x^2] - E[x]^2 rounds below 0 in the
    port's f32 sums: flax clips it to 0, so the channel's rstd is
    rsqrt(eps) and its input gradient scale·rsqrt(eps)·(dy - mean dy);
    unclipped, rsqrt(eps - |var|) would be 5 % or more larger.  (The
    statistic is rounding noise, so the JAX package's sums, in another
    order, need not go negative: the check is the port's alone.)"""
    for constant in (3.3, 2.9, 3.7, 5.1, 6.3):
        x, g, scale, bias, mean, var = _bn_case(2, constant=constant)
        xf = nchw(x)[:, 0]
        n = xf.numel()
        fast = float(xf.square().sum() / n - (xf.sum() / n).square())
        if fast < -4.5e-7:
            break
    else:
        pytest.fail("no constant gave a negative f32 variance")
    got = _port_bn(x, g, scale, bias, mean, var, True)
    dy = g[..., 0].astype(np.float64)
    want = scale[0] * (1e-5 ** -0.5) * (dy - dy.mean())
    close(got["dx"][..., 0], want)
    assert got["var"][0] == np.float32(0.9) * var[0]


def test_batch_norm_keeps_the_input_and_channel_statistics_only():
    """The training-mode BatchNorm saves the (bf16) input and per-channel
    vectors; plain ops under autograd would keep f32 copies of the
    activation."""
    x = torch.randn(2, 4, 6, 6, dtype=torch.bfloat16, requires_grad=True)
    bn = resnet.FlaxBatchNorm(4, device="cpu").train()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = bn(x)
    big = [t for t in saved if t.numel() == x.numel()]
    assert len(big) == 1 and big[0].dtype == torch.bfloat16
    assert all(t.numel() <= 4 for t in saved if t.numel() != x.numel())
    assert y.dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the whole model
# ----------------------------------------------------------------------


def _jax_init(model, size, seed=0, batch=2):
    return jax.jit(lambda key: jres.init_train_state(
        model, key, image_size=size, batch=batch))(jax.random.key(seed))


def _jax_apply(model, params, stats, x, train):
    return jax.jit(lambda p, s, x: jres.apply(model, p, s, x, train=train))(
        params, stats, jnp.asarray(x))


def _jax_state(model, size, seed=0, perturb=True):
    """A flax model's (params, batch_stats) as numpy, with every scale,
    bias and statistic moved off its initial value so that each one
    shows in the outputs."""
    params, stats = _jax_init(model, size, seed)
    if not perturb:
        return jax.tree.map(np.asarray, (params, stats))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), params)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1 * np.abs(
        rng.standard_normal(a.shape)).astype(np.float32), stats)
    return params, stats


def _port(model_fn, params, stats, **kw):
    model = model_fn(device="cpu", **kw)
    return resnet.load_jax_params(model, params, stats)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("train", [True, False])
def test_resnet18_thin_matches_flax(size, train):
    jm = jres.resnet18_thin()
    params, stats = _jax_state(jm, size)
    x = np.random.default_rng(size).standard_normal(
        (4, size, size, 3)).astype(np.float32)
    logits, new = _jax_apply(jm, params, stats, x, train)
    model = _port(resnet.resnet18_thin, params, stats)
    with torch.no_grad():
        got, got_stats = resnet.apply(model, torch.from_numpy(x), train)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=RTOL,
                               atol=RTOL * float(np.abs(logits).max()))
    assert set(got_stats) == {n for n, _ in model.named_buffers()}
    _, tree = resnet.to_jax(model)
    jax.tree.map(lambda a, b: close(a, np.asarray(b)), tree, dict(new))
    if not train:
        jax.tree.map(np.testing.assert_array_equal, tree, stats)


def test_bf16_resnet18_thin_close_to_flax():
    """bf16 compute in both: the rounding points differ (the frameworks'
    bf16 convs and casts), so the stated tolerance is 3e-2 of the
    largest logit and 2e-2 of each statistic's largest value."""
    jm = jres.resnet18_thin(dtype=jnp.bfloat16)
    params, stats = _jax_state(jm, 32, seed=3)
    x = np.random.default_rng(5).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    logits, new = _jax_apply(jm, params, stats, x, True)
    model = _port(resnet.resnet18_thin, params, stats, dtype=torch.bfloat16)
    with torch.no_grad():
        got, _ = resnet.apply(model, torch.from_numpy(x), True)
    assert got.dtype == torch.float32
    close(got.numpy(), np.asarray(logits), rel=3e-2, what="bf16 logits")
    _, tree = resnet.to_jax(model)
    jax.tree.map(lambda a, b: close(a, np.asarray(b), rel=2e-2), tree,
                 dict(new))


def test_resnet50_count_leaves_and_forward():
    jm = jres.resnet50(num_classes=1000, dtype=jnp.float32)
    params, stats = _jax_init(jm, 32, batch=1)
    model = _port(resnet.resnet50, params, stats, dtype=torch.float32)
    n = resnet.n_params(model)
    assert n == sum(a.size for a in jax.tree.leaves(params))
    assert 25_000_000 < n < 26_100_000, n  # as tests/test_resnet.py
    back_params, back_stats = resnet.to_jax(model)
    jax.tree.map(np.testing.assert_array_equal, back_params,
                 jax.tree.map(np.asarray, params))
    jax.tree.map(np.testing.assert_array_equal, back_stats,
                 jax.tree.map(np.asarray, stats))
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    # in training mode the last stage normalises over 2 x 1 x 1 values a
    # channel, where E[x^2] - E[x]^2 cancels: the two frameworks' f32 sums
    # in other orders part by up to 3e-4 of the largest logit there
    for train, rel in ((False, RTOL), (True, 1e-3)):
        want, _ = _jax_apply(jm, params, stats, x, train)
        with torch.no_grad():
            got, _ = resnet.apply(model, torch.from_numpy(x), train)
        close(got.numpy(), np.asarray(want), rel=rel, what=f"train={train}")


def test_conv_flops_count():
    """``chip_smoke.resnet_flops``, phase 16's MFU numerator: resnet18_thin
    at 32^2 by hand (conv_init 602,112; block 0: 8,192 + 73,728 + 32,768
    + 32,768; block 1: 65,536 + 73,728 + 32,768 + 65,536; head 1,280),
    and ResNet-50 at 224^2 as torchvision's 4.089 GMAC."""
    import chip_smoke

    thin = resnet.resnet18_thin(device="cpu")
    assert chip_smoke.resnet_flops(thin, 32) == 988_416
    fifty = resnet.resnet50(device="cpu", dtype=torch.float32)
    assert chip_smoke.resnet_flops(fifty, 224) == 2 * 4_089_184_256


def test_load_jax_params_uses_every_leaf_once():
    jm = jres.resnet18_thin()
    params, stats = _jax_state(jm, 32, perturb=False)
    model = resnet.resnet18_thin(device="cpu")
    extra = dict(params, Dense_1={"kernel": np.zeros((64, 10), np.float32)})
    with pytest.raises(ValueError, match="Dense_1"):
        resnet.load_jax_params(model, extra, stats)
    missing = {k: v for k, v in stats.items() if k != "bn_init"}
    with pytest.raises(KeyError, match="bn_init"):
        resnet.load_jax_params(model, params, missing)
    wrong = dict(params, conv_init={"kernel": np.zeros((3, 3, 3, 8),
                                                       np.float32)})
    with pytest.raises(ValueError, match="conv_init"):
        resnet.load_jax_params(model, wrong, stats)


def test_init_params_distributions():
    model = resnet.resnet18_thin(device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    w = model.blocks[1].conv1.weight  # 3x3, fan_in 16 * 9
    std = (16 * 9) ** -0.5
    w = w.detach()
    assert abs(float(w.std()) - std) < 0.15 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    for block in model.blocks:
        assert not block.bn2.scale.any() and block.bn0.scale.eq(1).all()
    assert not model.head.bias.any()
    assert model.conv_init.weight.is_contiguous(
        memory_format=torch.channels_last)


# ----------------------------------------------------------------------
# the training step: SGD with Nesterov momentum under the cosine decay
# ----------------------------------------------------------------------


def _jax_layout(model, value):
    """``value(tensor)`` of every parameter, in the flax layout."""
    out = {}
    for path, module in resnet._jax_names(model):
        for (collection, leaf), t in resnet._leaves(module).items():
            if collection != "params":
                continue
            a = value(t).detach().float().numpy()
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a.transpose(resnet._TO_JAX[a.ndim])
    return out


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 7])
def test_cosine_lr_is_optax(k):
    want = float(optax.cosine_decay_schedule(0.1, 4)(k))
    assert train_resnet.cosine_lr(0.1, k, 4) == pytest.approx(want, rel=1e-6)


def test_three_sgd_nesterov_cosine_steps_match_optax():
    steps, lr, momentum, B, size = 3, 0.1, 0.9, 4, 32
    jm = jres.resnet18_thin(num_classes=10)
    params, stats = _jax_state(jm, size, seed=2, perturb=False)
    opt = optax.sgd(optax.cosine_decay_schedule(lr, steps),
                    momentum=momentum, nesterov=True)
    opt_state = opt.init(params)

    @jax.jit
    def jax_step(params, stats, opt_state, images, labels):
        def loss_fn(p):
            logits, new_stats = jres.apply(jm, p, stats, images, train=True)
            logp = jax.nn.log_softmax(logits)
            loss = -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))
            return loss, new_stats
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                loss, grads)

    model = _port(resnet.resnet18_thin, params, stats, num_classes=10)
    sgd = train_resnet.sgd(model, lr, momentum)
    step = train_resnet.make_train_step(model, sgd, lr, steps)
    rng = np.random.default_rng(7)
    for i in range(steps):
        x = rng.standard_normal((B, size, size, 3)).astype(np.float32)
        y = rng.integers(0, 10, B)
        params, stats, opt_state, jloss, grads = jax_step(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(y))
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
        for name, got, want in (
                ("grad", _jax_layout(model, lambda p: p.grad), grads),
                ("param", _jax_layout(model, lambda p: p), params),
                ("momentum", _jax_layout(
                    model, lambda p: sgd.state[p]["momentum_buffer"]),
                 opt_state[0].trace)):
            jax.tree.map(lambda a, b, name=name: close(
                a, np.asarray(b), what=f"step {i} {name}"), got, dict(want))
        _, got_stats = resnet.to_jax(model)
        jax.tree.map(lambda a, b: close(a, np.asarray(b)), got_stats,
                     dict(stats))
        assert sgd.param_groups[0]["lr"] == pytest.approx(
            lr * 0.5 * (1 + math.cos(math.pi * i / steps)))
