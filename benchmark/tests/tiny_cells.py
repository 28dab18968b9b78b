"""Tiny cells for the CPU tests: a copy of the benchmark's files in a
temporary checkout, with small configurations, mixes and cells added as
files beside the real ones (nothing existing is edited)."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DENSE = {"model_type": "mistral", "hidden_act": "silu",
              "hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256,
              "max_position_embeddings": 256, "rope_theta": 1000000.0,
              "rms_norm_eps": 1e-05, "sliding_window": None,
              "initializer_range": 0.02, "tie_word_embeddings": True,
              "torch_dtype": "bfloat16"}
TINY_MOE = {**TINY_DENSE, "model_type": "mixtral", "num_local_experts": 4,
            "num_experts_per_tok": 2, "output_router_logits": True,
            "router_aux_loss_coef": 0.01}
# set as the cells' limits are, from readings at this size on the CPU:
# sound bf16 runs read loss 2e-5 - 3.4e-5, grad 8e-4 - 1.7e-3, change
# 7e-4 - 4.2e-3; the fp8 control grad 1.3e-2 - 0.16, the exchange left
# out grad 0.06 - 0.19, half the batch grad 0.44 - 0.72
TINY_LIMITS = {"loss_gap": 1e-3, "grad_gap": 5e-3, "change_gap": 0.02}


def _config_file(name: str, config: dict) -> dict:
    return {"name": name, "source": "https://arxiv.org/abs/2310.06825",
            "config": config, "reduced": [], "published": {}, "assumed": {},
            "departures": [], "deployment": "a CPU test"}


def _cell_file(mesh=None, **kw) -> dict:
    job = {"mesh": mesh, "remat": False, "remat_policy": None,
           "chunked_ce": False, "check_steps": 3, "profile_steps": 2,
           "limits": dict(TINY_LIMITS)}
    job.update(kw)
    return job


def make_root(tmp: Path, cells: dict | None = None) -> Path:
    """A checkout under ``tmp`` holding ``BENCHMARK.json`` and the
    benchmark's files, plus the tiny configurations ``tiny-dense`` and
    ``tiny-moe``, the mixes ``zipf.b2.t32`` and ``zipf.b4.t16`` and the
    cells of ``cells`` (name -> (config, cell file fields, chips[,
    traffic])); returns its root."""
    root = tmp / "checkout"
    bench = root / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    for name, cfg in (("tiny-dense", TINY_DENSE), ("tiny-moe", TINY_MOE)):
        (bench / "configs" / f"{name}.json").write_text(
            json.dumps(_config_file(name, cfg)))
    for name, B, T in (("zipf.b2.t32", 2, 32), ("zipf.b4.t16", 4, 16)):
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(
            {"generator": "zipf_tokens", "batch": B, "seq_len": T,
             "zipf_exponent": 1.0, "pool_batches": 6}))
    cells = cells or {"tiny.dense": ("tiny-dense", {}, 1)}
    used = set()
    for name, (config, fields, chips, *traffic) in cells.items():
        (bench / "cells" / f"{name}.json").write_text(
            json.dumps(_cell_file(**fields)))
        spec["workloads"].append(
            {"name": name, "config": config,
             "traffic": traffic[0] if traffic else "zipf.b2.t32",
             "chips": chips, "why": "a CPU test"})
        used.add(config)
    for name in sorted(used):
        spec["configs"].append(
            {"name": name, "source": "https://arxiv.org/abs/2310.06825",
             "file": f"benchmark/configs/{name}.json", "reduced": [],
             "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
