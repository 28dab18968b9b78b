"""dist-MNIST in the port against the JAX package, on the CPU.

The loader's arrays are bitwise the JAX package's; the CNN's forward and
SGD-with-momentum steps match the JAX model and ``optax.sgd`` with the
JAX weights carried across; two gloo ranks under DDP end where one rank
on the global batch ends; and ``train_mnist`` reaches the 98 % of
``tests/test_models.py`` on the synthetic digits at its sizes.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_workers as workers
from pytorch_operator_tpu.data import mnist as jdata
from pytorch_operator_tpu.models import mnist_cnn as jcnn
from pytorch_operator_tpu_torch import train_mnist
from pytorch_operator_tpu_torch.data import mnist as tdata
from pytorch_operator_tpu_torch.models import mnist_cnn as tcnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("split,size,seed", [("train", 300, 0),
                                             ("test", 64, 3),
                                             ("train", 1, 7)])
def test_synthetic_digits_are_bitwise_the_jax_packages(split, size, seed):
    xt, yt = tdata.load(None, split=split, synthetic_size=size, seed=seed)
    xj, yj = jdata.load(None, split=split, synthetic_size=size, seed=seed)
    assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
    assert xt.tobytes() == xj.tobytes() and yt.tobytes() == yj.tobytes()
    for (a, b), (c, d) in zip(tdata.batches(xt, yt, 16, seed=2),
                              jdata.batches(xj, yj, 16, seed=2)):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


def test_idx_loader_matches_jax(tmp_path):
    import gzip
    import struct

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, 5, dtype=np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 0x801, 5) + lbls.tobytes())
    with pytest.raises(FileNotFoundError):  # the labels are not .gz
        tdata.load(str(tmp_path), split="test")
    os.rename(tmp_path / "t10k-images-idx3-ubyte.gz",
              tmp_path / "t10k-images-idx3-ubyte")
    with open(tmp_path / "t10k-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    xt, yt = tdata.load(str(tmp_path), split="test")
    xj, yj = jdata.load(str(tmp_path), split="test")
    assert xt.tobytes() == xj.tobytes() and yt.tobytes() == yj.tobytes()
    assert xt.shape == (5, 28, 28, 1)


def _jax_params(seed=0):
    return jax.tree.map(np.asarray, jcnn.init_params(jax.random.key(seed)))


def test_forward_matches_jax():
    tree = _jax_params()
    x, _ = tdata.load(None, synthetic_size=32, seed=4)
    model = tcnn.load_jax_params(tcnn.MnistCNN(device="cpu"), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jcnn.forward(tree, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    back = tcnn.params_to_numpy(model)
    for layer in tree:
        for k in ("w", "b"):
            assert back[layer][k].tobytes() == tree[layer][k].tobytes()


def test_sgd_momentum_steps_match_optax():
    """Two steps, so that the momentum trace is used (the first step's
    trace is the gradient itself)."""
    tree = _jax_params(1)
    xs, ys = tdata.load(None, synthetic_size=64, seed=5)
    lr, momentum = 0.05, 0.9
    opt = optax.sgd(lr, momentum=momentum)
    params, state = tree, opt.init(tree)
    model = tcnn.load_jax_params(tcnn.MnistCNN(device="cpu"), tree)
    topt = tcnn.sgd(model, lr, momentum)
    for i in range(2):
        x, y = xs[32 * i:32 * (i + 1)], ys[32 * i:32 * (i + 1)]

        def loss_fn(p):
            return jcnn.nll_loss(jcnn.forward(p, jnp.asarray(x)),
                                 jnp.asarray(y))
        jl, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        loss = tcnn.nll_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        topt.step()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
        got = tcnn.params_to_numpy(model)
        for layer in got:
            for k in ("w", "b"):
                np.testing.assert_allclose(got[layer][k],
                                           np.asarray(params[layer][k]),
                                           atol=1e-6, err_msg=(i, layer, k))


def _train(world: int, path: str, extra=()) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    launch = [sys.executable]
    if world > 1:
        launch += ["-m", "torch.distributed.run", "--nproc-per-node",
                   str(world), "--master-addr", "127.0.0.1",
                   "--master-port", str(workers.free_port())]
    proc = subprocess.run(
        launch + ["-m", "pytorch_operator_tpu_torch.train_mnist",
                  "--device", "cpu", "--synthetic-size", "512",
                  "--batch-size", "64", "--epochs", "1", "--lr", "0.05",
                  "--momentum", "0.9", "--log-interval", "2",
                  "--save-model", path, *extra],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_two_rank_ddp_equals_one_rank_on_the_global_batch(tmp_path):
    one = _train(1, str(tmp_path / "one.npz"),
                 ["--profile-dir", str(tmp_path / "trace"),
                  "--profile-steps", "2"])
    assert "profile trace written" in one
    assert (tmp_path / "trace" / "trace_rank0.json").stat().st_size > 0
    two = _train(2, str(tmp_path / "two.npz"))
    assert "[worker 0/2] devices: 2 x cpu" in two
    a, b = np.load(tmp_path / "one.npz"), np.load(tmp_path / "two.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 8
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
    # the logged losses are the global batch's mean on both
    la = re.findall(r"loss=(\S+)", one)
    lb = re.findall(r"loss=(\S+)", two)
    assert la and len(la) == len(lb)
    np.testing.assert_allclose(np.float64(lb), np.float64(la), rtol=1e-4)


@pytest.fixture()
def two_threads():
    """The suite runs beside other workers: more intra-op threads than
    cores only make the convolutions wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_train_mnist_reaches_98_percent(capsys, two_threads):
    """The sizes and optimizer of test_models.py's synthetic-digits
    test: 2048 training images, 512 test images, batch 128, SGD 0.05
    with momentum 0.9, at most 5 epochs."""
    rc = train_mnist.main(["--device", "cpu", "--synthetic-size", "2048",
                           "--batch-size", "128", "--epochs", "5",
                           "--lr", "0.05", "--momentum", "0.9",
                           "--seed", "0", "--target-accuracy", "0.98"])
    out = capsys.readouterr().out
    assert rc == 0
    acc = [float(a) for a in re.findall(r"^accuracy=(\S+)", out,
                                        re.MULTILINE)]
    assert acc and acc[-1] >= 0.98, out
    assert "Train Epoch: 1 [0/2048 (0%)]" in out
    assert re.search(r"\d+ img/s", out)
