"""The pod seam: the port's launcher under the env the JAX operator renders.

Every H100 PyTorchJob of ``pytorch_operator_tpu_torch/manifests/`` goes
through the JAX package's conversion path and controller (fake pod and
service controls, as ``tests/test_controller.py``), and each rendered
pod is held to the JAX job it stands for: WORLD_SIZE = pods, RANK =
0..pods-1, the master's MASTER_ADDR ``localhost`` and the workers' the
master's service, the cards as ``nvidia.com/gpu``, the launcher as the
command, the mesh flags' product = pods x cards.  ``chip_smoke.py``'s
literal env (phase 17) must equal that rendering.

Then the launcher runs under a rendered 2-pod env on the CPU (gloo), one
subprocess a pod, with MASTER_ADDR 127.0.0.1 and a free MASTER_PORT in
place of the service and the manifest's port: dist_allreduce over 2 pods
x 2 processes, and the thin ResNet whose first loss must be one
process's, and the JAX package's model's, on the global batch the JAX
example's two processes assemble (relative 1e-3; f32 on the CPU, the
ranks sum in another order).  The
launcher's exit codes are held to the operator's retry classification,
and the fault-C4 guard and the launcher's refusals are checked.  Every
subprocess runs under a time limit of at most 240 s and is collected in
``finally``.
"""

import os
import re
import signal
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import torch_dist_workers as workers
from pytorch_operator_tpu.api.v1.defaults import set_defaults
from pytorch_operator_tpu.api.v1.types import PyTorchJob
from pytorch_operator_tpu.api.v1.validation import validate_spec
from pytorch_operator_tpu.controller import PyTorchController
from pytorch_operator_tpu.controller.train_util import is_retryable_exit_code
from pytorch_operator_tpu.k8s import serde
from pytorch_operator_tpu.k8s.fake import FakeCluster
from pytorch_operator_tpu.metrics.prometheus import Registry
from pytorch_operator_tpu.models import resnet as jres
from pytorch_operator_tpu.runtime import (
    FakePodControl,
    FakeRecorder,
    FakeServiceControl,
    JobControllerConfig,
)
from pytorch_operator_tpu_torch import launch, train_resnet
from pytorch_operator_tpu_torch.models import resnet
from pytorch_operator_tpu_torch.utils import (
    maybe_init_distributed,
    process_index,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
MANIFESTS = os.path.join(REPO, "pytorch_operator_tpu_torch", "manifests")
LAUNCH = ["python", "-m", "pytorch_operator_tpu_torch.launch"]
# the env keys the operator renders and the launcher reads or sets
C10D = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "GROUP_RANK", "MASTER_ADDR",
        "MASTER_PORT")
# each manifest: the JAX job it stands for and (pods, cards a pod)
JOBS = {"pytorch_job_mnist_cpu.yaml": ("mnist/v1/pytorch_job_mnist_cpu.yaml",
                                       1, 0),
        "pytorch_job_sendrecv.yaml": ("smoke-dist/pytorch_job_sendrecv.yaml",
                                      2, 4),
        "pytorch_job_mnist.yaml": ("mnist/v1/pytorch_job_mnist_xla.yaml", 4,
                                   4),
        "pytorch_job_resnet.yaml": ("resnet/v1/pytorch_job_resnet_tpu.yaml",
                                    4, 4),
        "pytorch_job_llama_fsdp.yaml": (
            "llama/v1/pytorch_job_llama_fsdp.yaml", 32, 4),
        "pytorch_job_llama_longctx.yaml": (
            "llama/v1/pytorch_job_llama_longctx.yaml", 32, 4)}
MESH_FLAGS = ("dp", "fsdp", "tp", "sp", "pp", "ep")
TIMEOUT = 240


def _load(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def render(wire: dict, name: str | None = None) -> list[dict]:
    """The pods the JAX controller creates for the job ``wire``, in rank
    order (the master, then each worker)."""
    wire = dict(wire, metadata=dict(wire["metadata"], namespace="default",
                                    uid="uid-launch"))
    if name is not None:
        wire["metadata"]["name"] = name
    job = serde.from_dict(PyTorchJob, wire)
    set_defaults(job)
    validate_spec(job.spec)
    ctl = PyTorchController(FakeCluster(), config=JobControllerConfig(),
                            recorder=FakeRecorder(), registry=Registry())
    ctl.pod_control = FakePodControl()
    ctl.service_control = FakeServiceControl()
    ctl.update_status_handler = lambda status: None
    ctl.job_informer.store.add(job.to_dict())
    _, err = ctl.sync_job(f"default/{job.metadata.name}")
    assert err is None
    pods = ctl.pod_control.templates
    return sorted(pods, key=lambda p: int(_env(p)["RANK"]))


def _container(pod: dict) -> dict:
    [c] = pod["spec"]["containers"]
    return c


def _env(pod: dict) -> dict:
    return {e["name"]: e["value"] for e in _container(pod)["env"]}


def _flags(args: list[str]) -> dict:
    """``--name=value`` and ``--name value`` arguments by name."""
    out, i = {}, 0
    while i < len(args):
        name, eq, value = args[i].partition("=")
        if not eq and i + 1 < len(args) and not args[i + 1].startswith("--"):
            value, i = args[i + 1], i + 1
        out[name.lstrip("-")] = value
        i += 1
    return out


@pytest.mark.parametrize("manifest", sorted(JOBS))
def test_manifest_renders_the_jax_jobs_world(manifest):
    jax_job, pods, cards = JOBS[manifest]
    wire = _load(os.path.join(MANIFESTS, manifest))
    jax_wire = _load(os.path.join(REPO, "examples", jax_job))
    rendered = render(wire)
    name = wire["metadata"]["name"]
    assert len(rendered) == pods == len(render(jax_wire))
    for rank, pod in enumerate(rendered):
        env, c = _env(pod), _container(pod)
        assert env["WORLD_SIZE"] == str(pods) and env["RANK"] == str(rank)
        assert "LOCAL_RANK" not in env
        assert env["MASTER_ADDR"] == ("localhost" if rank == 0
                                      else f"{name}-master-0")
        assert c["command"][:3] == LAUNCH
        assert c["command"][-1].startswith("pytorch_operator_tpu_torch.")
        limits = (c.get("resources") or {}).get("limits") or {}
        assert "google.com/tpu" not in limits
        assert limits.get("nvidia.com/gpu", 0) == cards
        assert not pod["spec"].get("nodeSelector")
    # the JAX job's chips: its pods' google.com/tpu
    jax_chips = sum(int(((_container(p).get("resources") or {}).get("limits")
                         or {}).get("google.com/tpu", 0))
                    for p in render(jax_wire))
    assert pods * cards == jax_chips
    args = _container(rendered[0]).get("args") or []
    jax_args = _container(render(jax_wire)[0]).get("args") or []
    # the JAX job's batch, model and mesh flags, unchanged
    kept = {k: v for k, v in _flags(jax_args).items()
            if k != "checkpoint-dir"}
    assert kept.items() <= _flags(args).items()
    mesh = [int(v) for k, v in _flags(args).items() if k in MESH_FLAGS]
    if mesh:
        assert int(np.prod(mesh)) == pods * cards


def test_every_manifest_is_listed():
    assert sorted(f for f in os.listdir(MANIFESTS)
                  if f.endswith(".yaml")) == sorted(JOBS)


def test_chip_smoke_env_is_the_controllers():
    """chip_smoke writes out the operator's env (it imports no JAX
    package); it is the rendering less the job's push token."""
    wire = _load(os.path.join(MANIFESTS, "pytorch_job_sendrecv.yaml"))
    for rank, pod in enumerate(render(wire, name=chip_smoke.POD_JOB)):
        env = _env(pod)
        assert env.pop("PYTORCH_OPERATOR_PUSH_TOKEN")
        assert env == chip_smoke.operator_env(chip_smoke.POD_JOB, 2, rank,
                                              int(env["MASTER_PORT"]))


def _pod_envs(manifest: str = "pytorch_job_sendrecv.yaml") -> list[dict]:
    """Each pod's rendered env on this host: MASTER_ADDR 127.0.0.1 where
    it names the master's service, a free MASTER_PORT."""
    port = str(workers.free_port())
    envs = []
    for pod in render(_load(os.path.join(MANIFESTS, manifest))):
        env = _env(pod)
        if env["MASTER_ADDR"] != "localhost":
            env["MASTER_ADDR"] = "127.0.0.1"
        env["MASTER_PORT"] = port
        envs.append(env)
    return envs


def _base_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in C10D}
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS,
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(pod_env: dict, argv: list[str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_operator_tpu_torch.launch", *argv],
        cwd=REPO, env={**_base_env(), **pod_env}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def _stop(procs: list) -> None:
    """SIGTERM to every launcher still running (it ends its workers),
    then SIGKILL."""
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGTERM)
    for p in procs:
        try:
            p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


def run_pods(argv: list[str], envs: list[dict]) -> list[tuple]:
    """The launcher with ``argv`` in one subprocess a pod, all at once:
    each pod's (rc, stdout, stderr)."""
    procs = []
    try:
        for env in envs:
            procs.append(_start(env, argv))
        deadline = time.monotonic() + TIMEOUT
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                for p in procs]
        return [(p.returncode, *o) for p, o in zip(procs, outs)]
    finally:
        _stop(procs)


def test_two_pods_of_two_processes_reduce_over_four():
    """Pod 0's launcher serves the static rendezvous's store on
    MASTER_PORT and its workers' ``tcp://`` init joins it as a client
    (under TORCHELASTIC_USE_AGENT_STORE): a second bind of the port
    would fail the run."""
    runs = run_pods(["--nproc-per-node", "2",
                     "pytorch_operator_tpu_torch.dist_allreduce", "--device",
                     "cpu"], _pod_envs())
    assert [rc for rc, _, _ in runs] == [0, 0], [e[-3000:] for *_, e in runs]
    out = "".join(o for _, o, _ in runs)
    assert out.count("all_reduce ok: psum(rank) == 6 on all 4 devices") == 4
    assert out.count("ppermute ring echo ok") == 4
    assert out.count("smoke-dist passed") == 4
    # each pod's processes hold the global ranks node * 2 + local
    for (_, o, _), ranks in zip(runs, ((0, 1), (2, 3))):
        assert sorted(int(r) for r in re.findall(
            r"\[worker (\d)/4\] global devices: 4", o)) == list(ranks)


def jax_example_pool(pid: int, B: int, size: int, classes: int,
                     entries: int) -> list:
    """``examples/resnet/train_resnet.py:98-106`` in numpy: process
    ``pid``'s draw of the pool's global batches."""
    rng = np.random.default_rng(pid)
    shape = (B, size, size, 3)
    return [(rng.standard_normal(shape, dtype=np.float32),
             rng.integers(0, classes, B)) for _ in range(entries)]


def test_launched_resnet_sees_the_jax_examples_global_batch():
    """The thin ResNet on 2 pods x 2 processes: its first loss is one
    process's step on the global batch the JAX example's two processes
    put on their devices (rows [0, B/2) of process 0's draw, [B/2, B) of
    process 1's), from the same torch-seeded weights, and the JAX
    package's model's loss on that batch with those weights."""
    B, size = 8, 32
    runs = run_pods(["--nproc-per-node", "2",
                     "pytorch_operator_tpu_torch.train_resnet", "--device",
                     "cpu", "--tiny", "--steps", "1", "--batch-size", str(B),
                     "--image-size", str(size), "--log-interval", "1"],
                    _pod_envs())
    assert [rc for rc, _, _ in runs] == [0, 0], [e[-3000:] for *_, e in runs]
    out = "".join(o for _, o, _ in runs)
    assert "[worker 0/4] 4 x cpu" in out
    [loss] = [float(x) for x in re.findall(r"^step 0: loss=(\S+) ", out,
                                          re.M)]
    draws = [jax_example_pool(pid, B, size, 1000, 1)[0] for pid in (0, 1)]
    x = np.concatenate([draws[0][0][:B // 2], draws[1][0][B // 2:]])
    y = np.concatenate([draws[0][1][:B // 2], draws[1][1][B // 2:]])
    model = resnet.resnet18_thin(1000, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    # the JAX package's model on the same weights: its train-mode loss
    params, stats = resnet.to_jax(model)
    logits, _ = jax.jit(lambda p, s, x: jres.apply(
        jres.resnet18_thin(num_classes=1000), p, s, x, train=True))(
        params, stats, jnp.asarray(x))
    logp = jax.nn.log_softmax(logits)
    jax_loss = float(-jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(y)[:, None], 1)))
    step = train_resnet.make_train_step(
        model, train_resnet.sgd(model, 0.1, 0.9), 0.1, 1)
    want = float(step(torch.from_numpy(x), torch.from_numpy(y)))
    assert loss == pytest.approx(want, rel=1e-3)
    assert loss == pytest.approx(jax_loss, rel=1e-3)


@pytest.mark.parametrize("env", [
    # the launcher's workers: GROUP_RANK is the pod's RANK
    {"GROUP_RANK": "{node}", "RANK": "{rank}", "LOCAL_RANK": "{local}"},
    # one process a pod under the operator's env: RANK is the pod's
    {"RANK": "{node}"}])
def test_batch_pool_rows_are_the_jax_examples(monkeypatch, env):
    """Each (node, local) rank of 2 pods x 2 keeps the rows the JAX
    example's process ``node`` puts on its device ``rank``: rows [r·B/4,
    (r+1)·B/4) of that process's draw.  At one process a pod (the second
    env) each pod keeps its half of its own draw."""
    B, size, classes, entries = 8, 4, 10, 2
    per_node = 2 if "LOCAL_RANK" in env else 1
    world = 2 * per_node
    for node in range(2):
        draws = jax_example_pool(node, B, size, classes, entries)
        for local in range(per_node):
            rank = node * per_node + local
            for k in C10D:
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v.format(node=node, rank=rank,
                                               local=local))
            assert process_index() == node
            pool = train_resnet.batch_pool(process_index(), rank, world, B,
                                           size, classes, entries, "cpu")
            rows = slice(rank * B // world, (rank + 1) * B // world)
            for (x, y), (jx, jy) in zip(pool, draws):
                np.testing.assert_array_equal(x.numpy(), jx[rows])
                np.testing.assert_array_equal(y.numpy(), jy[rows])


def test_process_index_without_env(monkeypatch):
    for k in C10D:
        monkeypatch.delenv(k, raising=False)
    assert process_index() == 0


@pytest.mark.parametrize("what, want", [(["exit", "138"], 138),
                                        (["kill"], 137), (["exit", "1"], 1),
                                        (["collective"], 137), (["ok"], 0)])
def test_launcher_exits_as_the_first_failed_worker(what, want):
    """Under the one-pod env mnist_cpu renders: a worker's exit code, or
    128 + n for signal n, reaches the operator as a JAX process's would,
    and the operator's ExitCode policy classifies it so.  ``collective``:
    the killed worker's peer fails too (exit 1, its gloo all-reduce
    broken), and the pod still reports the kill."""
    [env] = _pod_envs("pytorch_job_mnist_cpu.yaml")
    [(rc, _, err)] = run_pods(["--nproc-per-node", "2",
                               "torch_launch_worker", *what], [env])
    assert rc == want, err[-3000:]
    assert is_retryable_exit_code(rc) == (rc in (137, 138))


def test_sigterm_to_the_launcher_ends_every_worker(tmp_path):
    """The kubelet's delete: the launcher exits 143 and no worker is left
    30 s later."""
    [env] = _pod_envs("pytorch_job_mnist_cpu.yaml")
    pidfiles = [tmp_path / f"pid{r}" for r in range(2)]
    proc = _start(env, ["--nproc-per-node", "2", "torch_launch_worker",
                        "sleep", str(tmp_path)])
    pids = []
    try:
        deadline = time.monotonic() + TIMEOUT
        while not all(p.exists() and p.read_text() for p in pidfiles):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        pids = [int(p.read_text()) for p in pidfiles]
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
        assert proc.returncode == 128 + signal.SIGTERM
        deadline = time.monotonic() + 30
        alive = pids
        while alive and time.monotonic() < deadline:
            alive = [p for p in alive if _alive(p)]
            time.sleep(0.2)
        assert not alive, f"workers {alive} outlived the launcher"
    finally:
        _stop([proc])
        for pid in pids:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_launcher_argv_follows_the_pod_env(monkeypatch):
    for k in C10D:
        monkeypatch.delenv(k, raising=False)
    # a bare host: one node on its own
    assert launch.torchrun_argv("4", "m", ["--x"]) == [
        "--standalone", "--nnodes", "1", "--nproc-per-node", "4",
        "--max-restarts", "0", "-m", "m", "--x"]
    monkeypatch.setenv("WORLD_SIZE", "32")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("MASTER_ADDR", "job-master-0")
    monkeypatch.setenv("MASTER_PORT", "23456")
    assert launch.torchrun_argv("gpu", "m", []) == [
        "--nnodes", "32", "--node-rank", "5", "--master-addr",
        "job-master-0", "--master-port", "23456", "--rdzv-backend", "static",
        "--nproc-per-node", "gpu", "--max-restarts", "0", "-m", "m"]
    monkeypatch.setenv("RANK", "32")
    with pytest.raises(ValueError, match="outside WORLD_SIZE"):
        launch.torchrun_argv("4", "m", [])
    assert [launch.exit_code(c) for c in (0, 1, 138, -9, -15)] == [
        0, 1, 138, 137, 143]


def test_launcher_refuses_without_a_card(monkeypatch):
    """No card visible and no --nproc-per-node: torchrun's ``gpu`` count
    raises rather than start CPU processes."""
    for k in C10D:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="Cuda is not available"):
        launch.main(["pytorch_operator_tpu_torch.dist_allreduce"])


def _failure(exitcode: int, timestamp: int):
    return types.SimpleNamespace(exitcode=exitcode, timestamp=timestamp)


@pytest.mark.parametrize("failures, rank", [
    # the earliest, whatever its code
    ({0: _failure(1, 10), 1: _failure(-9, 12)}, 0),
    ({0: _failure(-15, 12), 1: _failure(138, 10)}, 1),
    # a tie, or a peer stamped a second before the failure it followed:
    # a SIGTERM (torchrun ends the others so) last, exit 1 (a broken
    # collective) next to last, then the earliest, then the rank
    ({0: _failure(-15, 10), 1: _failure(138, 10)}, 1),
    ({0: _failure(-15, 10), 1: _failure(1, 11)}, 1),
    ({0: _failure(1, 10), 1: _failure(-9, 10)}, 1),
    ({0: _failure(1, 10), 1: _failure(-9, 11)}, 1),
    ({0: _failure(1, 10), 1: _failure(-15, 10), 2: _failure(138, 11)}, 2),
    ({0: _failure(-9, 11), 1: _failure(138, 10)}, 1),
    ({0: _failure(1, 10), 1: _failure(1, 10)}, 0),
    ({0: _failure(-15, 10), 1: _failure(-15, 10)}, 0)])
def test_first_failure_prefers_the_cause_within_a_second(failures, rank):
    assert launch.first_failure(failures)[0] == rank


@pytest.fixture()
def four_cards(monkeypatch):
    """A host with four visible cards, the operator's env of pod 1 of 2."""
    for k in C10D:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    return monkeypatch


def test_c4_guard_refuses_one_process_on_a_multi_card_pod(four_cards):
    with pytest.raises(RuntimeError,
                       match="python -m pytorch_operator_tpu_torch.launch"):
        maybe_init_distributed("cuda")
    # the same pod's processes under the launcher (torchrun sets
    # LOCAL_RANK) go on to the existing checks: this one, NCCL's
    four_cards.setenv("LOCAL_RANK", "1")
    four_cards.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="has no NCCL"):
        maybe_init_distributed("cuda")


def test_c4_guard_leaves_the_other_cases(four_cards):
    # the CPU device, as mnist_cpu asks
    four_cards.setenv("WORLD_SIZE", "1")
    four_cards.setenv("RANK", "0")
    assert maybe_init_distributed("cpu") == (0, 1)
    # one card visible
    four_cards.setattr(torch.cuda, "device_count", lambda: 1)
    assert maybe_init_distributed("cuda") == (0, 1)
    # no WORLD_SIZE: a plain process on a multi-card host
    four_cards.setattr(torch.cuda, "device_count", lambda: 4)
    four_cards.delenv("WORLD_SIZE")
    assert maybe_init_distributed("cuda") == (0, 1)
