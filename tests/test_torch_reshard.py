"""``reshard_state`` on four gloo ranks, on the CPU: the port's
counterpart of ``tests/test_elastic.py``'s ``TestReshard``.

A state trained one AdamW step on fsdp 4 moves to fsdp 2 x tp 2 and
back, onto a mesh over two of the four ranks (the others hold nothing)
and back onto all four, with every gathered parameter and AdamW moment
bit for bit the same at each stop; the resharded state trains, and its
step is bit for bit the step of a fresh state on the same mesh restored
from a checkpoint of the same values.
"""

import json

import torch_dist_workers as workers


def test_reshard_state_on_four_ranks(tmp_path):
    workers.spawn(workers.reshard_worker, 4, str(tmp_path), timeout=150)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    for r, res in enumerate(ranks):
        # 2 + 9 per layer params, each with exp_avg, exp_avg_sq, step
        assert res["n_values"] == 4 * (2 + 9 * 2), res
        assert res["fsdp4_to_22"] and res["back_to_fsdp4"], (r, res)
        assert len(res["placements22"]) > 1, res  # tp plan and FSDP2
        assert res["step"] == 1
        assert res["state_is_none"] == (r >= 2), (r, res)
        assert res["old_state_dropped"]
        assert res["grown_equal_on_all"]
        assert res["moved_equals_restored"], (r, res)
        assert res["step_bitwise"], (r, res)
        assert res["step_losses"][0] == res["step_losses"][1]
        if r < 2:
            assert res["to_two_ranks"] and res["grown_is_trained"], (r, res)
            assert res["two_rank_step"] == 2
            assert res["two_rank_loss"] > 0
    assert ranks[0]["two_rank_loss"] == ranks[1]["two_rank_loss"]
