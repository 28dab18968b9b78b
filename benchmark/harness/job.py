"""One rank of a cell: the port's training step built from the cell's
files, driven through its check steps, the measured window and (with
``--trace 1``) a profile of a few steady steps; then the plain reference
on the check steps' batches, once the program's state is freed.

What the window drives is the port's own step
(``parallel.train.make_train_step`` on ``models.llama.Llama`` or
``models.moe.MoELlama``, AdamW from ``parallel.train.adamw``); the model
is laid out as ``sharded_init`` lays it out and its weights are the
benchmark's (``harness.weights``), written into its parameters on the
device.  The window does not synchronize on any step: a CUDA event marks
each step boundary on the step's stream and the losses stay on the
device until it closes.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch
import torch.distributed as dist

from benchmark.harness import profile as prof_mod
from benchmark.harness.traffic import token_pool
from benchmark.harness.weights import dims, expert_of, leaves, make
from benchmark.reference.model import follow

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
# AdamW's settings, the port's parallel.train.adamw(3e-4, 0.1), on both
# sides; one warm-up step after the check steps
LR, WEIGHT_DECAY = 3e-4, 0.1
WARMUP_STEPS = 1


def port_config(cell):
    """The port's config for the cell: the published keys of its
    configuration file read into ``LlamaConfig`` / ``MoEConfig``, with the
    cell's remat options and both kernels on."""
    from pytorch_operator_tpu_torch.models import llama, moe

    c = cell.config["config"]
    d = dims(c)
    if not c.get("tie_word_embeddings", False):
        raise ValueError("the port's models tie the head to the embedding; "
                         "the configuration must say tie_word_embeddings")
    kw = dict(vocab_size=d["V"], dim=d["D"], n_layers=d["L"],
              n_heads=d["H"], n_kv_heads=d["Hk"], ffn_dim=d["F"],
              max_seq_len=c["max_position_embeddings"],
              rope_theta=d["theta"], norm_eps=d["eps"],
              dtype=DTYPES[c["torch_dtype"]], remat=cell.job["remat"],
              remat_policy=cell.job["remat_policy"], use_flash=True,
              use_fused_norm=True)
    if d["Dh"] != d["D"] // d["H"]:
        raise ValueError("the port's head size is hidden_size / heads")
    if c.get("sliding_window") is not None:
        raise ValueError("the port's attention has no sliding window")
    if d["E"]:
        if d["aux_coef"] != moe.AUX_LOSS_WEIGHT:
            raise ValueError(f"the port trains the MoE with aux weight "
                             f"{moe.AUX_LOSS_WEIGHT}, the configuration "
                             f"says {d['aux_coef']}")
        return moe.MoEConfig(n_experts=d["E"], top_k=d["k"], **kw)
    return llama.LlamaConfig(**kw)


def place(cfg, mesh, device):
    """The model of ``cfg``, its memory allocated and not filled: on one
    device the plain model, on a mesh ``sharded_init``'s layout."""
    from pytorch_operator_tpu_torch.models import moe
    from pytorch_operator_tpu_torch.models.llama import Llama
    from pytorch_operator_tpu_torch.parallel import train

    if mesh is not None and mesh.size() > 1:
        return train._place(cfg, mesh)
    cls = moe.MoELlama if isinstance(cfg, moe.MoEConfig) else Llama
    return cls(cfg, device="meta").to_empty(device=device)


def program_leaves(model, config: dict) -> list:
    """(leaf name, parameter, expert index in its local tensor or None)
    of every leaf this rank holds, in ``weights.leaves``' order."""
    from torch.distributed.tensor import DTensor

    out = []
    for name, _, _ in leaves(config):
        parts = name.split(".")
        if parts[0] != "layers":
            out.append((name, getattr(model, name), None))
            continue
        blk = model.layers[int(parts[1])]
        p = getattr(blk, parts[2])
        e = expert_of(name)
        if e is None:
            out.append((name, p if isinstance(p, torch.nn.Parameter)
                        else p.weight, None))
            continue
        n_local = p.to_local().shape[0] if isinstance(p, DTensor) \
            else p.shape[0]
        if blk.expert_first <= e < blk.expert_first + n_local:
            out.append((name, p, e - blk.expert_first))
    return out


def _local(p):
    """This rank's shard of a DTensor (an expert bank's: its experts)."""
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


def _whole(p):
    """The whole value of a parameter or moment that is not an expert
    bank: a DTensor (FSDP2's, tp's) is gathered."""
    from torch.distributed.tensor import DTensor

    return p.full_tensor() if isinstance(p, DTensor) else p


@torch.no_grad()
def fill(model, config: dict, seed: int, device) -> None:
    """Write the benchmark's weights into the model: each leaf made on the
    device from (seed, name); an expert into its slot of this rank's
    bank; any other sharded parameter through ``llama.assign`` (each rank
    keeps its shard of the whole value)."""
    from pytorch_operator_tpu_torch.models import llama

    d = dims(config)
    shapes = {n: (s, k) for n, s, k in leaves(config)}
    for name, p, e in program_leaves(model, config):
        shape, kind = shapes[name]
        w = make(seed, name, shape, kind, d["std"], device, p.dtype)
        if e is not None:
            _local(p)[e].copy_(w)
        else:
            llama.assign(p, w)
        del w


def leaf_norms(items) -> torch.Tensor:
    """‖t‖ of each tensor, in f32, as one device tensor."""
    return torch.stack([t.float().norm() for t in items])


def grad_norms(model, config, optimizer) -> torch.Tensor:
    """Each leaf's first gradient as the optimizer got it: ‖m‖ / (1 − β1)
    of AdamW's first moment after one step."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    items = []
    for _, p, e in program_leaves(model, config):
        m = optimizer.state[p]["exp_avg"]
        items.append(_whole(m) if e is None else _local(m)[e])
    return leaf_norms(items) / (1 - beta1)


def change_norms(model, config, seed) -> torch.Tensor:
    """‖p − p0‖ of each leaf, p0 made again from (seed, name)."""
    d = dims(config)
    shapes = {n: (s, k) for n, s, k in leaves(config)}
    out = []
    with torch.no_grad():
        for name, p, e in program_leaves(model, config):
            v = _whole(p) if e is None else _local(p)[e]
            shape, kind = shapes[name]
            p0 = make(seed, name, shape, kind, d["std"], v.device, p.dtype)
            out.append((v.float() - p0.float()).norm())
    return torch.stack(out)


class Agree:
    """Whether the window is over, the same answer on every rank: the
    first rank whose host clock has passed ``seconds`` decides, and a gloo
    all-reduce of one flag a step (host memory only, no device wait)
    tells the others, so every rank runs the same steps."""

    def __init__(self, seconds: float, group):
        self.seconds, self.group = seconds, group
        self.start = None

    def begin(self) -> None:
        self.start = time.perf_counter()

    def over(self) -> bool:
        done = time.perf_counter() - self.start >= self.seconds
        if self.group is None:
            return done
        flag = torch.tensor([int(done)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def run_rank(cell, seed: int, seconds: float, trace: bool, device,
             wall0: float, mesh=None, gloo=None, world: int = 1,
             rank: int = 0) -> dict:
    """Everything one rank measures and reads; see the module docstring.
    ``wall0``: the run's start on the host's wall clock."""
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
    )

    job, config = cell.job, cell.config["config"]
    parts = {}
    t = time.perf_counter()
    if device.type == "cuda":
        kernels.load()
    parts["library_load_s"] = time.perf_counter() - t
    if trace and device.type == "cuda":
        prof_mod.warm_profiler()

    t = time.perf_counter()
    cfg = port_config(cell)
    model = place(cfg, mesh, device)
    fill(model, config, seed, device)
    optimizer = adamw(model, LR, WEIGHT_DECAY)
    step = make_train_step(cfg, model, optimizer, mesh=mesh,
                           chunked_ce=job["chunked_ce"])
    state = TrainState(model, optimizer)
    pool = token_pool(cell.traffic, dims(config)["V"], seed, device)
    _sync(device)
    parts["weights_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # the check steps: the window's own call and feed, on the pool's
    # first batches, the same model and optimizer the window trains on
    t = time.perf_counter()
    n_check, P = job["check_steps"], pool.shape[0]
    check_losses = []
    for i in range(n_check):
        state, m = step(state, pool[i % P])
        check_losses.append(m["loss"])
        if i == 0:
            g_norms = grad_norms(model, config, optimizer)
    c_norms = change_norms(model, config, seed)
    for j in range(WARMUP_STEPS):
        state, _ = step(state, pool[(n_check + j) % P])
    _sync(device)
    parts["warmup_s"] = time.perf_counter() - t

    # the measured window
    agree = Agree(seconds, gloo if world > 1 else None)
    if gloo is not None:
        dist.barrier(group=gloo)
    launches0 = kernels.launch_counts()
    i = n_check + WARMUP_STEPS
    win_losses, events = [], [_event(device)]
    setup_s = time.time() - wall0
    agree.begin()
    while True:
        state, m = step(state, pool[i % P])
        i += 1
        win_losses.append(m["loss"])
        events.append(_event(device))
        if agree.over():
            break
    _sync(device)
    wall_s = time.perf_counter() - agree.start
    steps = len(win_losses)
    launched = kernels.launch_counts()
    per_step = {k: (launched[k] - launches0.get(k, 0)) / steps
                for k in launched if launched[k] - launches0.get(k, 0)}
    step_ms = ([events[j].elapsed_time(events[j + 1]) for j in range(steps)]
               if device.type == "cuda" else [])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)

    traced = None
    if trace:
        traced = profile_steps(lambda k: step(state, pool[k % P]), i,
                               job["profile_steps"], device)

    nonfinite = int((~torch.isfinite(torch.stack(win_losses))).sum())
    program = {"losses": [float(x) for x in check_losses],
               "grad_norms": g_norms.tolist(),
               "change_norms": c_norms.tolist(),
               "nonfinite_losses": nonfinite}
    names = [n for n, _, _ in program_leaves(model, config)]
    program["grad_norms"] = dict(zip(names, program["grad_norms"]))
    program["change_norms"] = dict(zip(names, program["change_norms"]))
    batches = [pool[i % P].clone() for i in range(n_check)]

    # free the program's state before the reference runs
    del step, state, model, optimizer, pool, m, win_losses, check_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    group = dist.group.WORLD if world > 1 else None
    ref = follow(config, seed, batches, device, lr=LR,
                 weight_decay=WEIGHT_DECAY, group=group)
    ref_s = time.perf_counter() - t
    return {"rank": rank, "setup_s": setup_s, "setup_parts": parts,
            "steps": steps, "wall_s": wall_s, "step_ms": step_ms,
            "peak_bytes": peak, "launches_per_step": per_step,
            "trace": traced, "program": program, "reference": ref,
            "reference_s": ref_s}


def profile_steps(run_step, first: int, steps: int, device) -> dict | None:
    """A profile of ``steps`` steady steps (up to three takes, while the
    profile lacks a record of a launch the port counted): the trace's
    summary and the steps' device-clock time between boundary events.
    Raises where the third take still lacks one: kernel time summed from
    such a trace is short, and every share read from it too high."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch import kernels

    if device.type != "cuda":
        return None
    k = first
    for take in range(1, 4):
        _sync(device)
        before = kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            events = [_event(device)]
            for _ in range(steps):
                run_step(k)
                k += 1
                events.append(_event(device))
            _sync(device)
        after = kernels.launch_counts()
        summary = prof_mod.summarize(prof, steps)
        del prof
        summary["device_ms"] = events[0].elapsed_time(events[-1])
        summary["takes"] = take
        launched = {s: after[s] - before.get(s, 0) for s in after}
        if prof_mod.complete(summary, launched):
            return summary
    raise RuntimeError(f"the profiler dropped records of the port's "
                       f"launches in {take} takes of {steps} steps")


def p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
