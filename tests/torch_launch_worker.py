"""A worker for ``tests/test_torch_launch.py``, run by the launcher
(``python -m pytorch_operator_tpu_torch.launch --nproc-per-node 2
torch_launch_worker <what> [arg]``) with ``tests/`` on the path.

``exit N``: rank 1 exits with N; ``kill``: rank 1 sends itself SIGKILL;
the other rank ends after a few seconds, unless the launcher ends it
first.  ``collective``: both ranks join a gloo group, rank 0 waits in an
all-reduce that rank 1 never enters, and rank 1 sends itself SIGKILL,
so that rank 0's collective breaks (exit 1) as its peer dies.  ``sleep
DIR``: every rank writes its pid to ``DIR/pid<rank>`` and sleeps until
it is ended.  Imports nothing but the standard library outside
``collective``, so that each rank starts fast.
"""

import os
import signal
import sys
import time


def main() -> int:
    what, rank = sys.argv[1], int(os.environ["RANK"])
    if what == "collective":
        import datetime

        import torch
        import torch.distributed as dist

        dist.init_process_group("gloo",
                                timeout=datetime.timedelta(seconds=60))
        if rank == 0:
            dist.all_reduce(torch.zeros(1))
        time.sleep(2)  # rank 0 is in its all-reduce by now
        os.kill(os.getpid(), signal.SIGKILL)
    if what == "sleep":
        with open(os.path.join(sys.argv[2], f"pid{rank}"), "w") as f:
            f.write(str(os.getpid()))
        time.sleep(600)
    elif rank == 1 and what == "exit":
        return int(sys.argv[2])
    elif rank == 1 and what == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
