"""The pipeline trainer's command line, on the CPU.

- ``train_llama --pp`` refuses what the JAX entry refuses, with the JAX
  entry's own messages (it runs in a subprocess on host devices).
- The README's command, ``--pp 2 --microbatches 2 --pp-schedule 1f1b``
  on two gloo ranks under ``torch.distributed.run``, and ``--pp 1`` in
  one process train the losses of the one-process run without ``--pp``
  (rtol 1e-4: f32, the microbatches' means summed in another order).
"""

import re

import numpy as np
import pytest

from pytorch_operator_tpu_torch import train_llama
from test_torch_sp_cli import _jax_entry_error, _run_trainer


@pytest.mark.parametrize("argv,world", [
    (["--pp", "2", "--fsdp", "2"], 4),
    (["--pp", "2", "--sp", "2"], 2),
    (["--pp", "4"], 2),
    (["--pp", "4"], 4),
    (["--pp", "2", "--batch-size", "6", "--microbatches", "4"], 2)],
    ids=["with-fsdp", "with-sp", "world", "layers", "microbatches"])
def test_pp_argument_errors_match_jax(argv, world):
    argv = ["--model", "tiny", *argv]
    want = _jax_entry_error(argv, world)
    args = train_llama.parse_args(["--device", "cpu", *argv])
    with pytest.raises(SystemExit) as e:
        train_llama.pp_stages(args, world, train_llama.MODELS[args.model]())
    assert str(e.value) == f"train_llama: error: {want}"


def test_pp_flags_parse():
    args = train_llama.parse_args(["--device", "cpu", "--pp", "2"])
    assert (args.microbatches, args.pp_schedule) == (4, "gpipe")
    assert train_llama.pp_stages(args, 2, train_llama.MODELS["tiny"]()) == 2
    with pytest.raises(SystemExit):
        train_llama.parse_args(["--device", "cpu", "--pp", "2",
                                "--pp-schedule", "2f2b"])


def _losses(text):
    return np.array(re.findall(r"^step \d+: loss=(\S+)", text,
                               re.MULTILINE), float)


def test_train_llama_pp_trains_the_plain_losses():
    whole = _losses(_run_trainer(1, []))
    out = _run_trainer(2, ["--pp", "2", "--microbatches", "2",
                           "--pp-schedule", "1f1b"])
    assert ("[worker 0/2] 1f1b pipeline mesh pp=2 microbatches=2 over 2 "
            "device(s)") in out
    assert "training complete" in out
    one = _run_trainer(1, ["--pp", "1", "--microbatches", "2"])
    assert len(whole) == 3
    np.testing.assert_allclose(_losses(out), whole, rtol=1e-4)
    np.testing.assert_allclose(_losses(one), whole, rtol=1e-4)
