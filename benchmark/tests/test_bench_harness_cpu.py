"""A tiny cell through the harness on the CPU, to the contract's last
line; and the faults the comparison must catch, planted underneath the
timed path, each making ``correct`` false."""

import json
import subprocess
import sys

import pytest
import torch

import tiny_cells
from tiny_cells import ROOT
from benchmark.harness import check, runner

KEYS = ("correct", "attempted", "failed", "metrics", "device")
DEVICE_METRICS = ("tokens_per_s", "step_ms_p95", "peak_mem_gib", "mfu_pct",
                  "optimizer_ms", "attn_fwd_roofline_pct",
                  "attn_bwd_roofline_pct", "expert_matmul_ms",
                  "nccl_share_pct", "device_idle_pct")
EP4 = {"mesh": {"dp": 1, "fsdp": 1, "tp": 1, "ep": 4}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.make_root(tmp_path_factory.mktemp("bench"), {
        "tiny.dense": ("tiny-dense", {}, 1),
        "tiny.moe": ("tiny-moe", {}, 1),
        "tiny.moe.ep4": ("tiny-moe", EP4, 4, "zipf.b4.t16")})


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.moe"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(root, cell, trace):
    line, earlier, checks = runner.execute(cell, 2 ** 31 + 77, 0.3, trace,
                                           "cpu", root=root)
    assert tuple(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert json.loads(json.dumps(line)) == line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    # without a card no device metric is reported
    assert not set(line["metrics"]) & set(DEVICE_METRICS)
    assert line["device"]["platform"] == "cpu"
    assert set(line["metrics"]) == ({"setup_s"} if not trace else set())
    assert [c.split(":")[0] for c in checks] == [
        f"check {n}" for n in line["checks"]]
    assert any("setup_parts" in e for e in earlier)


@pytest.mark.parametrize("cell", ["mistral-7b.pretrain.t4096",
                                  "mixtral-8x7b.ep4.t4096"])
def test_run_py_refuses_without_a_card(cell):
    """Exit 2 and no result; a four-card cell's ranks, started before the
    look for a card, are ended with it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_run_py_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/: no result."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mistral-7b.pretrain.t4096", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -- faults planted underneath the timed path -------------------------


def _frozen(monkeypatch):
    """A step that returns its state unchanged: AdamW at lr 0."""
    from pytorch_operator_tpu_torch.parallel import train

    real = train.adamw
    monkeypatch.setattr(train, "adamw", lambda m, lr, wd: real(m, 0.0, 0.0))


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from pytorch_operator_tpu_torch.parallel import train

    real = train.tied_ce
    half = lambda model, out, targets, *a: real(  # noqa: E731
        model, out[: out.shape[0] // 2], targets[: out.shape[0] // 2], *a)
    monkeypatch.setattr(train, "tied_ce", half)


def _loss_altered(monkeypatch):
    """The answer (the loss) altered where it is produced."""
    from pytorch_operator_tpu_torch.parallel import train

    real = train.tied_ce
    monkeypatch.setattr(train, "tied_ce",
                        lambda *a: real(*a) * 1.05)


@pytest.mark.parametrize("plant", [_frozen, _half_batch, _loss_altered])
@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.moe"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, plant, cell):
    plant(monkeypatch)
    line, _, _ = runner.execute(cell, 3, 0.1, False, "cpu", root=root)
    assert line["correct"] is False, line["checks"]


def test_sound_tiny_ep4_is_correct(root):
    line, _, _ = runner.execute("tiny.moe.ep4", 4, 0.1, False, "cpu",
                                root=root)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 4


def _no_exchange_task(cell, device, mesh, gloo, world, rank, *args):
    """``_window_task`` with the experts' all-reduce across ranks left
    out (each rank keeps its own experts' partial sum)."""
    from pytorch_operator_tpu_torch.utils import collectives

    collectives.reduce_from_group = lambda x, group: x
    return runner._window_task(cell, device, mesh, gloo, world, rank, *args)


def test_the_exchange_left_out_is_not_correct(root):
    from benchmark.harness import spec

    cell = spec.cell("tiny.moe.ep4", root)
    results = runner.on_ranks(cell, "cpu", root, _no_exchange_task, 4, 0.1,
                              False, 0.0)
    line, _, _ = runner.conclude(cell, results, False, "cpu", None)
    assert line["correct"] is False, line["checks"]


def test_unset_limits_make_no_run_correct():
    prog = {"losses": [1.0], "grad_norms": {"a": 1.0},
            "change_norms": {"a": 1.0}, "nonfinite_losses": 0}
    got = check.compare(prog, dict(prog), {"loss_gap": None,
                                           "grad_gap": 1.0,
                                           "change_gap": 1.0})
    assert got["correct"] is False
    got = check.compare(prog, dict(prog), {"loss_gap": 0.0,
                                           "grad_gap": 0.0,
                                           "change_gap": 0.0})
    assert got["correct"] is True
