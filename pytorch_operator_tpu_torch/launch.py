"""One process a card in a pod that the operator starts.

The operator gives every replica of a PyTorchJob the env of one process
a pod: ``WORLD_SIZE`` = the pods, ``RANK`` = this pod's index,
``MASTER_ADDR`` (``localhost`` on the master) and ``MASTER_PORT``
(``controller/tpu_env.py`` of the JAX package).  A JAX process drives
every chip of its host; each process of the port drives one card.  The
launcher bridges the two: it runs ``torch.distributed.run`` in this
process with

    --nnodes $WORLD_SIZE --node-rank $RANK
    --nproc-per-node <the visible cards>
    --master-addr $MASTER_ADDR --master-port $MASTER_PORT
    --rdzv-backend static --max-restarts 0

so that each card's process gets ``RANK`` = node · nproc + local,
``WORLD_SIZE`` = pods · nproc, ``LOCAL_RANK`` and ``GROUP_RANK`` (the
pod's ``RANK``: the JAX process index, ``utils.process_index``), and
joins the agent's store on ``MASTER_PORT``.  A pod's container runs

    python -m pytorch_operator_tpu_torch.launch \\
        pytorch_operator_tpu_torch.train_resnet --batch-size 1024

(``manifests/`` holds one such PyTorchJob for each job of the JAX
examples).  The visible cards are torchrun's ``--nproc-per-node gpu``:
``torch.cuda.device_count()``, which honours the
``CUDA_VISIBLE_DEVICES`` the device plugin sets, and a ``ValueError``
when no card is visible.  ``--nproc-per-node N`` goes to torchrun as
given (CPU processes, with the trainer's ``--device cpu``).  Without
``WORLD_SIZE`` it runs one node on its own (``torchrun --standalone``).

The restarts are the operator's (the pod's restart policy), so the
launcher exits with what a JAX process would have: 0 when every worker
did, else the exit code of the first worker that failed, 128 + n for
one ended by signal n (a SIGKILLed worker gives 137, one that exits 138
gives 138: both retryable under ``RestartPolicy: ExitCode``).  A SIGTERM
or SIGINT to the launcher ends every worker, and the launcher exits
128 + n.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

from pytorch_operator_tpu_torch.utils.distributed import _env_int


def torchrun_argv(nproc: str, module: str, args: list[str]) -> list[str]:
    """``torch.distributed.run``'s arguments for this pod's env."""
    if not os.environ.get("WORLD_SIZE"):
        node = ["--standalone", "--nnodes", "1"]
    else:
        pods, rank = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
        if not 0 <= rank < pods:
            raise ValueError(f"RANK={rank} is outside WORLD_SIZE={pods}")
        node = ["--nnodes", str(pods), "--node-rank", str(rank),
                "--master-addr", os.environ.get("MASTER_ADDR", "localhost"),
                "--master-port", str(_env_int("MASTER_PORT", 23456)),
                "--rdzv-backend", "static"]
    return node + ["--nproc-per-node", nproc, "--max-restarts", "0",
                   "-m", module, *args]


def exit_code(worker_exitcode: int) -> int:
    """A worker's exit code as its container would report it: torchrun
    reports a worker ended by signal n as -n."""
    return 128 - worker_exitcode if worker_exitcode < 0 else worker_exitcode


def first_failure(failures: dict) -> tuple:
    """The (rank, failure) of ``ChildFailedError.failures`` whose code
    the pod reports: the earliest.  torchrun stamps a failure in whole
    seconds, from the worker's error file or else when its poll finds
    it, and once one worker has failed it ends the others by SIGTERM and
    lists them too.  So a worker that was killed, a peer whose
    collective then broke (exit 1) and a peer that torchrun ended can
    tie or swap by a second.  Among the failures within a second of the
    earliest, a SIGTERM comes last, an exit code 1 before it, and the
    rest by time, then by rank."""
    t0 = min(f.timestamp for f in failures.values())
    return min(((r, f) for r, f in failures.items()
                if f.timestamp <= t0 + 1),
               key=lambda rf: (rf[1].exitcode == -signal.SIGTERM,
                               rf[1].exitcode == 1, rf[1].timestamp, rf[0]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="run a module of the port once per card of this pod",
        allow_abbrev=False)
    parser.add_argument("--nproc-per-node", default="gpu",
                        help="processes on this pod, as torchrun takes it "
                             "(default: gpu, the visible CUDA devices)")
    parser.add_argument("module", help="the module each process runs, "
                                       "e.g. pytorch_operator_tpu_torch."
                                       "train_llama")
    parser.add_argument("args", nargs=argparse.REMAINDER,
                        help="the module's arguments")
    a = parser.parse_args(argv)
    from torch.distributed import run as torchrun
    from torch.distributed.elastic.multiprocessing.api import SignalException
    from torch.distributed.elastic.multiprocessing.errors import (
        ChildFailedError,
    )

    argv = torchrun_argv(a.nproc_per_node, a.module, a.args)

    def stop(signum, frame):
        raise SignalException(f"launcher got signal {signum}",
                              sigval=signal.Signals(signum))

    # torchrun installs the same handlers once the workers start; these
    # cover the rendezvous before it
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, stop)
    try:
        torchrun.run(torchrun.parse_args(argv))
    except ChildFailedError as e:
        rank, failure = first_failure(e.failures)
        print(f"launch: worker {rank} failed with exit code "
              f"{failure.exitcode}", file=sys.stderr, flush=True)
        return exit_code(failure.exitcode)
    except SignalException as e:
        return 128 + int(e.sigval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
