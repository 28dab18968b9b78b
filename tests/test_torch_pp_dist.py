"""The port's pipeline on gloo ranks, on the CPU.

- The P2P pipeline (``PipeComm``, ``batch_isend_irecv``) on 2 and 4 gloo
  processes (``tests/torch_dist_workers.py``) against the loopback of
  every stage in one process, for both schedules, bit for bit: each
  stage's layer outputs and input gradients in the order of its ticks,
  its parameters' gradients and the loss.  Only the transport differs.
- A checkpoint written by ``train_llama --pp 2`` resumes in one process
  without ``--pp`` and on two under ``--fsdp 2``, and one written
  without ``--pp`` resumes under ``--pp 2``, with the losses of the run
  that went on (rtol 1e-4: f32, the same arithmetic but for the
  summation order of the layouts).
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

import torch_dist_workers as workers
from test_torch_sp_cli import _run_trainer


@pytest.mark.parametrize("world", [2, 4])
def test_p2p_pipeline_is_the_loopback_bit_for_bit(world, tmp_path):
    cfg = dict(dim=64, n_layers=2 * world, n_heads=4, n_kv_heads=2,
               ffn_dim=128, vocab_size=256, max_seq_len=16)
    M = 4
    batch = np.random.default_rng(world).integers(0, 256, (2 * M, 17))
    np.savez(tmp_path / "in.npz", cfg=json.dumps(cfg), microbatches=M,
             batch=batch)
    out = str(tmp_path / "out")
    workers.spawn(workers.pp_worker, world, str(tmp_path / "in.npz"), out,
                  timeout=120)
    for r in range(world):
        res = np.load(f"{out}.{r}.npz")
        assert int(res["profiler_chips"]) == world
        for schedule in ("gpipe", "1f1b"):
            keys = sorted(k[len(f"{schedule}/p2p/"):] for k in res.files
                          if k.startswith(f"{schedule}/p2p/"))
            assert {"y", "dx"} <= set(keys), keys
            assert ("loss" in keys) == (r == world - 1)
            assert sum(k.startswith("grad/layers.") for k in keys) == 18
            for k in keys:
                np.testing.assert_array_equal(
                    res[f"{schedule}/p2p/{k}"],
                    res[f"{schedule}/loopback/{k}"],
                    err_msg=f"rank {r} {schedule} {k}")


def _losses(text):
    return {int(i): float(x) for i, x in re.findall(
        r"^step (\d+): loss=(\S+)", text, re.MULTILINE)}


def test_pp_checkpoint_resumes_without_pp_and_under_fsdp(tmp_path):
    """Step 2's checkpoint of --pp 2 resumes without --pp (which writes
    step 3's, resumed in turn under --pp 2) and under --fsdp 2."""
    ckpt = tmp_path / "ckpt"
    common = ["--checkpoint-dir", str(ckpt), "--checkpoint-every", "2",
              "--steps", "4"]
    pp = ["--pp", "2", "--microbatches", "2", "--pp-schedule", "1f1b"]
    went_on = _losses(_run_trainer(2, [*pp, *common]))
    assert sorted(went_on) == [0, 1, 2, 3]
    for name, world, flags, start, every in (
            ("plain", 1, [], 2, "1"),
            ("fsdp", 2, ["--dp", "1", "--fsdp", "2", "--tp", "1"], 2, "100"),
            ("back_to_pp", 2, pp, 3, "100")):
        d = tmp_path / name
        src = tmp_path / "plain" if name == "back_to_pp" else ckpt
        shutil.copytree(src / str(start), d / str(start))
        text = _run_trainer(world, [*flags, "--checkpoint-dir", str(d),
                                    "--checkpoint-every", every,
                                    "--steps", "4"])
        assert (f"restored checkpoint at step {start} onto {world} "
                f"device(s)") in text, text
        resumed = _losses(text)
        assert sorted(resumed) == list(range(start, 4))
        np.testing.assert_allclose([resumed[i] for i in range(start, 4)],
                                   [went_on[i] for i in range(start, 4)],
                                   rtol=1e-4, err_msg=name)
    assert os.path.isdir(ckpt / "4")
