"""Worker processes for the port's multi-rank tests (gloo on the CPU).

The test files import JAX; these workers import only torch, numpy and
the port, so each spawned rank starts fast.  ``spawn`` starts ``world``
ranks of a worker with ``torch.multiprocessing`` on a free port and the
rendezvous env the operator injects, and waits with a time limit.
Rank 0 writes the results to a file the test reads.
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, *args, timeout: float = 240.0) -> None:
    """Run ``fn(rank, world, port, *args)`` in ``world`` processes; any
    rank's exception fails the call, and so does the time limit (the
    ranks are killed)."""
    ctx = mp.start_processes(fn, args=(world, free_port(), *args),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} at world {world} did "
                                   f"not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def _rank_env(rank: int, world: int, port: int) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)


def init_worker(rank, world, port, out_dir):
    """maybe_init_distributed from the env: each rank writes what it
    got."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    got = maybe_init_distributed("cpu")
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"got": list(got), "backend": dist.get_backend(),
                   "sum": t.item()}, f)
    dist.destroy_process_group()


def _full(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def step_worker(rank, world, port, spec_path, out_path):
    """The sharded step on the spec's mesh: sharded_init against the
    unsharded init, then the JAX weights loaded and ``steps`` steps on
    the spec's global batches; rank 0 writes losses, grad norms, the
    first step's full gradients and the shard sizes."""
    _rank_env(rank, world, port)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, make_train_step, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    data = np.load(spec["arrays"])
    maybe_init_distributed("cpu")
    mesh = make_mesh(*spec["mesh"], device="cpu")
    cfg = llama.tiny(**spec["cfg"])

    model = sharded_init(cfg, mesh, seed=spec["init_seed"])
    ref = llama.Llama(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(spec["init_seed"]))
    init_bitwise = all(
        torch.equal(p.full_tensor(), r)
        for p, r in zip(model.parameters(), ref.parameters()))
    del ref

    tree = {"embed": data["embed"], "final_norm": data["final_norm"],
            "layers": {k[len("layers/"):]: data[k] for k in data.files
                       if k.startswith("layers/")}}
    llama.load_jax_params(model, tree)
    optimizer = adamw(model, spec["lr"], weight_decay=spec["wd"])
    step = make_train_step(cfg, model, optimizer, mesh=mesh,
                           chunked_ce=spec["chunked_ce"],
                           ce_chunk=spec["ce_chunk"])
    state = TrainState(model, optimizer)
    losses, norms, grads = [], [], {}
    for i in range(spec["steps"]):
        state, m = step(state, data[f"batch{i}"])
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            grads = {n: _full(p.grad) for n, p in model.named_parameters()}
    # one row does not split over dp*fsdp >= 2: the step refuses it, as
    # the JAX mesh step's input sharding does
    try:
        step(state, data["batch0"][:1])
        refusal = None
    except ValueError as e:
        refusal = str(e)

    sizes = {}
    for n, p in model.named_parameters():
        st = optimizer.state[p]
        sizes[n] = {
            "full": p.numel(), "local": p.to_local().numel(),
            "placements": [str(x) for x in p.placements],
            "moments": [st[k].to_local().numel()
                        for k in ("exp_avg", "exp_avg_sq")],
            "moments_dtensor": all(isinstance(st[k], DTensor)
                                   for k in ("exp_avg", "exp_avg_sq"))}
    if rank == 0:
        np.savez(out_path, **{f"grad/{n}": g for n, g in grads.items()})
        with open(out_path + ".json", "w") as f:
            json.dump({"losses": losses, "norms": norms, "sizes": sizes,
                       "init_bitwise": init_bitwise, "refusal": refusal}, f)
    dist.destroy_process_group()


def restore_worker(rank, world, port, ckpt_dir, step, mesh_shape, out_path):
    """Restore checkpoint ``step`` onto a fresh sharded state of the tiny
    trainer model on ``mesh_shape``; rank 0 writes the full parameters
    and AdamW moments."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, restore_on_mesh, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    maybe_init_distributed("cpu")
    mesh = make_mesh(*mesh_shape, device="cpu")
    cfg = llama.tiny(max_seq_len=32, remat=True)
    model = sharded_init(cfg, mesh, seed=0)
    optimizer = adamw(model, 3e-4, weight_decay=0.1)
    state = restore_on_mesh(ckpt_dir, step, TrainState(model, optimizer))
    out = {}
    for n, p in model.named_parameters():
        out[f"model/{n}"] = _full(p)
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"optim/{n}/{k}"] = _full(optimizer.state[p][k])
        out[f"optim/{n}/step"] = _full(optimizer.state[p]["step"])
    if rank == 0:
        np.savez(out_path, step=state.step, **out)
    dist.destroy_process_group()


def ring_worker(rank, world, port, in_path, out_path):
    """For each case of the input file: this rank's chunk through the P2P
    ring (``RingComm`` over the world, gloo), forward and backward; rank 0
    also runs the loopback ring on the whole sequence in this process
    (the same thread count).  Each rank writes its chunk's out, dq, dk
    and dv; rank 0 the loopback's whole ones."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.parallel.ring_attention import (
        RingComm,
        ring_attention,
        ring_attention_loopback,
    )
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    data = np.load(in_path)
    maybe_init_distributed("cpu")
    comm = RingComm()
    out = {}
    for case in sorted({k.split("/")[0] for k in data.files}):
        layout = str(data[f"{case}/layout"])
        causal = bool(data[f"{case}/causal"])
        q, k, v, g = (torch.from_numpy(data[f"{case}/{x}"])
                      for x in ("q", "k", "v", "g"))
        rows = (torch.from_numpy(data[f"{case}/perm"]) if
                layout == "zigzag_pre" else torch.arange(q.shape[1]))
        mine = rows.chunk(world)[rank]
        xs = [x[:, mine].clone().requires_grad_(True) for x in (q, k, v)]
        o = ring_attention(*xs, comm, causal=causal, layout=layout)
        o.backward(g[:, mine])
        for name, t in zip(("out", "dq", "dk", "dv"),
                           (o, *(x.grad for x in xs))):
            out[f"{case}/p2p/{name}"] = t.detach().numpy()
        if rank == 0:
            xs = [x[:, rows].clone().requires_grad_(True) for x in (q, k, v)]
            o = ring_attention_loopback(*xs, world, causal=causal,
                                        layout=layout)
            o.backward(g[:, rows])
            for name, t in zip(("out", "dq", "dk", "dv"),
                               (o, *(x.grad for x in xs))):
                out[f"{case}/loopback/{name}"] = t.detach().numpy()
    np.savez(f"{out_path}.{rank}.npz", **out)
    dist.destroy_process_group()


def ulysses_worker(rank, world, port, in_path, out_path):
    """Ulysses through the model's sequence-parallel attention
    (``llama.sp_attention``, with its minimal kv repeat) on this rank's
    rows, forward and backward, for each case; each rank writes its
    rows' out, dq, dk and dv."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    data = np.load(in_path)
    maybe_init_distributed("cpu")
    out = {}
    for case in sorted({k.split("/")[0] for k in data.files}):
        q, k, v, g = (torch.from_numpy(data[f"{case}/{x}"])
                      for x in ("q", "k", "v", "g"))
        cfg = llama.tiny(use_flash=bool(data[f"{case}/flash"]))
        attn = llama.sp_attention(cfg, None, "ulysses")
        xs = [x.chunk(world, 1)[rank].clone().requires_grad_(True)
              for x in (q, k, v)]
        o = attn(*xs)
        o.backward(g.chunk(world, 1)[rank])
        for name, t in zip(("out", "dq", "dk", "dv"),
                           (o, *(x.grad for x in xs))):
            out[f"{case}/{name}"] = t.detach().numpy()
    np.savez(f"{out_path}.{rank}.npz", **out)
    dist.destroy_process_group()


def sp_step_worker(rank, world, port, spec_path, out_path):
    """The sequence-parallel step on the spec's (dp, fsdp, sp, tp) mesh
    for each of the spec's impls: sharded_init against the unsharded
    init, the JAX weights loaded and ``steps`` steps on the spec's global
    batches; rank 0 writes the losses, grad norms and the first step's
    full gradients of each impl."""
    _rank_env(rank, world, port)
    import dataclasses
    import gc

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_sp_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, make_sp_train_step, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    data = np.load(spec["arrays"])
    maybe_init_distributed("cpu")
    dp, fsdp, sp, tp = spec["mesh"]
    mesh = make_sp_mesh(dp, sp, fsdp=fsdp, tp=tp, device="cpu")
    cfg = llama.tiny(**spec["cfg"])
    if spec.get("remat_policy"):
        cfg = dataclasses.replace(cfg, remat=True, use_flash=True,
                                  remat_policy=spec["remat_policy"])
    tree = {"embed": data["embed"], "final_norm": data["final_norm"],
            "layers": {k[len("layers/"):]: data[k] for k in data.files
                       if k.startswith("layers/")}}
    res, grads = {}, {}
    for impl in spec["impls"]:
        model = sharded_init(cfg, mesh, seed=spec["init_seed"])
        ref = llama.Llama(cfg, device="cpu", generator=torch.Generator(
            ).manual_seed(spec["init_seed"]))
        init_bitwise = all(
            torch.equal(llama.full_value(p), r)
            for p, r in zip(model.parameters(), ref.parameters()))
        del ref
        llama.load_jax_params(model, tree)
        optimizer = adamw(model, spec["lr"], weight_decay=spec["wd"])
        step = make_sp_train_step(cfg, model, optimizer, mesh=mesh,
                                  impl=impl, chunked_ce=spec["chunked_ce"],
                                  ce_chunk=spec["ce_chunk"])
        state = TrainState(model, optimizer)
        losses, norms = [], []
        for i in range(spec["steps"]):
            state, m = step(state, data[f"batch{i}"])
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            if i == 0:
                grads.update({f"grad/{impl}/{n}": _full(p.grad)
                              for n, p in model.named_parameters()})
        res[impl] = {"losses": losses, "norms": norms,
                     "init_bitwise": init_bitwise,
                     "dtensor": any(isinstance(p, DTensor)
                                    for p in model.parameters())}
        del model, optimizer, state, step
        gc.collect()
    if rank == 0:
        np.savez(out_path, **grads)
        with open(out_path + ".json", "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def pp_record(stages, comm, batch, n_microbatches, schedule):
    """``pipeline_value_and_grad`` of Llama stages with the pipeline
    step's functions (embedding, the stage's blocks, the final norm, the
    tied head and CE / M), recording per stage, in the order of its
    autograd ticks, each output of its layers and the gradient of their
    input; then its parameters' gradients (before any sum over the
    stages) and, on the last stage, the loss."""
    from pytorch_operator_tpu_torch.parallel.pipeline import (
        PipeLoopback,
        pipeline_value_and_grad,
    )
    from pytorch_operator_tpu_torch.parallel.train import (
        cross_entropy_loss,
    )

    index = {id(st): st.layer_ids.start // len(st.layer_ids)
             for st in stages}
    rec = {s: {"y": [], "dx": []} for s in index.values()}
    M = n_microbatches

    def stage_fn(stage, x):
        y = stage.run_layers(x)
        if torch.is_grad_enabled():  # the run that is backpropagated
            r = rec[index[id(stage)]]
            r["y"].append(y.detach().clone())
            x.register_hook(lambda g: r["dx"].append(g.detach().clone()))
        return y

    def last_fn(stage, y, targets):
        logits = (stage.head(y, return_hidden=True) @ stage.embed.t())
        return cross_entropy_loss(logits.float(), targets) / M

    loss = pipeline_value_and_grad(
        lambda st, t: st.embed_tokens(t), stage_fn, last_fn,
        stages if isinstance(comm, PipeLoopback) else stages[0],
        batch[:, :-1], batch[:, 1:], comm, n_microbatches=M,
        schedule=schedule)
    for st in stages:
        r = rec[index[id(st)]]
        r["grads"] = {n: p.grad.clone() for n, p in st.named_parameters()
                      if p.grad is not None}
        if index[id(st)] == comm.n - 1:
            r["loss"] = loss
    return rec


def pp_worker(rank, world, port, in_path, out_path):
    """For each schedule: this rank's stage (``sharded_init`` with
    ``pp_param_specs``) through the P2P pipeline (``PipeComm`` over the
    world, gloo), and the loopback of every stage in this process on
    the same batch; each rank writes both records of its stage."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh
    from pytorch_operator_tpu_torch.parallel.pipeline import (
        SCHEDULES,
        PipeComm,
        PipeLoopback,
    )
    from pytorch_operator_tpu_torch.parallel.train import (
        sharded_init,
        with_step_profiler,
    )
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    data = np.load(in_path)
    maybe_init_distributed("cpu")
    mesh = make_named_mesh({"pp": world}, "cpu")
    comm = PipeComm(mesh["pp"].get_group())
    cfg = llama.tiny(**json.loads(str(data["cfg"])))
    M = int(data["microbatches"])
    batch = torch.from_numpy(data["batch"])
    # the step profiler sizes MFU from the pp mesh's ranks
    out = {"profiler_chips": with_step_profiler(
        lambda *a: a, cfg, mesh, batch=batch.shape[0],
        seq_len=batch.shape[1] - 1)[1].n_chips}
    for schedule in SCHEDULES:
        stage = sharded_init(cfg, mesh, seed=0,
                             specs=llama.pp_param_specs(cfg, world))
        got = pp_record([stage], comm, batch, M, schedule)[rank]
        want = pp_record(list(llama.pipeline_stages(cfg, world,
                                                    device="cpu")),
                         PipeLoopback(world), batch, M, schedule)[rank]
        for name, r in (("p2p", got), ("loopback", want)):
            key = f"{schedule}/{name}"
            out[f"{key}/y"] = torch.stack(r["y"]).numpy()
            if r["dx"]:
                out[f"{key}/dx"] = torch.stack(r["dx"]).numpy()
            for n, g in r["grads"].items():
                out[f"{key}/grad/{n}"] = g.numpy()
            if "loss" in r:
                out[f"{key}/loss"] = r["loss"].numpy()
    np.savez(f"{out_path}.{rank}.npz", **out)
    dist.destroy_process_group()


def gathered_state(state) -> dict:
    """Every parameter and AdamW tensor of a state, gathered whole, by
    name (collective over the state's mesh)."""
    out = {}
    for n, p in state.model.named_parameters():
        out[f"model/{n}"] = _full(p)
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"optim/{n}/{k}"] = _full(v)
    return out


def reshard_worker(rank, world, port, out_dir):
    """``reshard_state`` on four gloo ranks, after one AdamW step on
    fsdp 4: to fsdp 2 x tp 2 and back, then onto a mesh of ranks 0 and 1
    (ranks 2 and 3 get None) and back to all four; gathered values at
    each stop, and one step on fsdp 2 x tp 2 from the resharded state
    beside one from the same values restored from a checkpoint onto a
    fresh state on that mesh.  Each rank writes what it found."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, make_train_step, reshard_state, restore_on_mesh,
        save_checkpoint, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    maybe_init_distributed("cpu")
    cfg = llama.tiny(max_seq_len=64)
    batches = [np.random.default_rng(i).integers(0, cfg.vocab_size, (4, 65))
               for i in range(2)]
    mesh4 = make_mesh(1, 4, 1, "cpu")
    mesh22 = make_mesh(1, 2, 2, "cpu")
    mesh2 = make_mesh(1, 2, 1, "cpu", ranks=[0, 1])
    model = sharded_init(cfg, mesh4, seed=0)
    opt = adamw(model)
    state, _ = make_train_step(cfg, model, opt, mesh=mesh4)(
        TrainState(model, opt), batches[0])
    del model, opt
    ckpt = os.path.join(out_dir, "ckpt")
    save_checkpoint(state, ckpt)
    res = {}

    def same(a, b):
        return sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a)

    first = gathered_state(state)
    res["n_values"] = len(first)
    state = reshard_state(state, cfg, mesh22)
    res["placements22"] = sorted({str(p.placements) for p in
                                  state.model.parameters()})
    res["fsdp4_to_22"] = same(first, gathered_state(state))
    state = reshard_state(state, cfg, mesh4)
    res["back_to_fsdp4"] = same(first, gathered_state(state))
    res["step"] = state.step

    state2 = reshard_state(state, cfg, mesh2)
    res["state_is_none"] = state2 is None
    res["old_state_dropped"] = state.model is None
    if state2 is not None:
        res["to_two_ranks"] = same(first, gathered_state(state2))
        res["two_rank_sizes"] = sorted(
            p.to_local().numel() for p in state2.model.parameters())[-1]
        state2, m = make_train_step(cfg, state2.model, state2.optimizer,
                                    mesh=mesh2)(state2, batches[1])
        res["two_rank_loss"] = m["loss"].item()
        res["two_rank_step"] = state2.step
        after = gathered_state(state2)
    state = reshard_state(state2, cfg, mesh4)  # back onto all four ranks
    grown = gathered_state(state)
    if rank < 2:
        res["grown_is_trained"] = same(after, grown)
    obj = [None] * world
    dist.all_gather_object(obj, grown["model/embed"].sum().item())
    res["grown_equal_on_all"] = len(set(obj)) == 1

    # a step from the resharded state against a step from a fresh state
    # on fsdp 2 x tp 2 restored from the checkpoint of the same values
    state = reshard_state(state, cfg, mesh4)
    fresh = sharded_init(cfg, mesh4, seed=1)
    fresh = restore_on_mesh(ckpt, 1, TrainState(fresh, adamw(fresh)))
    moved = reshard_state(fresh, cfg, mesh22)
    model22 = sharded_init(cfg, mesh22, seed=1)
    built = restore_on_mesh(ckpt, 1, TrainState(model22, adamw(model22)))
    res["moved_equals_restored"] = same(gathered_state(moved),
                                        gathered_state(built))
    moved, m1 = make_train_step(cfg, moved.model, moved.optimizer,
                                mesh=mesh22)(moved, batches[1])
    built, m2 = make_train_step(cfg, built.model, built.optimizer,
                                mesh=mesh22)(built, batches[1])
    res["step_losses"] = [m1["loss"].item(), m2["loss"].item()]
    res["step_bitwise"] = same(gathered_state(moved), gathered_state(built))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def moe_step_worker(rank, world, port, spec_path, out_path):
    """The MoE step on the spec's (dp, fsdp, tp, ep) mesh: sharded_init
    against the unsharded init, the JAX weights loaded and ``steps``
    steps on the spec's global batches.  Rank 0 writes losses, grad
    norms, the first step's gathered gradients and each parameter's
    local and full sizes; every rank writes the gathered values of the
    parameters the ep ranks replicate, after the steps."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama, moe
    from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, make_train_step, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    data = np.load(spec["arrays"])
    maybe_init_distributed("cpu")
    mesh = make_named_mesh(dict(zip(("dp", "fsdp", "tp", "ep"),
                                    spec["mesh"])), "cpu")
    cfg = moe.tiny(**spec["cfg"])
    try:  # the ep dim splits experts, which a Llama model lacks
        sharded_init(llama.tiny(), mesh)
        refusal = None
    except ValueError as e:
        refusal = str(e)

    model = sharded_init(cfg, mesh, seed=spec["init_seed"])
    ref = moe.MoELlama(cfg, device="cpu", generator=torch.Generator(
        ).manual_seed(spec["init_seed"]))
    init_bitwise = all(
        torch.equal(llama.full_value(p), r)
        for p, r in zip(model.parameters(), ref.parameters()))
    del ref
    tree = {"embed": data["embed"], "final_norm": data["final_norm"],
            "layers": {k[len("layers/"):]: data[k] for k in data.files
                       if k.startswith("layers/")}}
    moe.load_jax_params(model, tree)
    optimizer = adamw(model, spec["lr"], weight_decay=spec["wd"])
    step = make_train_step(cfg, model, optimizer, mesh=mesh,
                           chunked_ce=spec["chunked_ce"],
                           ce_chunk=spec["ce_chunk"])
    state = TrainState(model, optimizer)
    losses, norms, grads = [], [], {}
    for i in range(spec["steps"]):
        state, m = step(state, data[f"batch{i}"])
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            grads = {n: _full(p.grad) for n, p in model.named_parameters()}
    replicated = {n: _full(p) for n, p in model.named_parameters()
                  if n.rsplit(".", 1)[-1] not in moe.EXPERT_BANKS}
    sizes = {n: [p.to_local().numel() if hasattr(p, "to_local")
                 else p.numel(), p.numel()]
             for n, p in model.named_parameters()}
    np.savez(f"{out_path}.{rank}.npz", **replicated)
    if rank == 0:
        np.savez(out_path, **{f"grad/{n}": g for n, g in grads.items()})
        with open(out_path + ".json", "w") as f:
            json.dump({"losses": losses, "norms": norms, "sizes": sizes,
                       "init_bitwise": init_bitwise, "refusal": refusal},
                      f)
    dist.destroy_process_group()


def moe_ep_average_worker(rank, world, port, out_path):
    """Two steps of the tiny MoE on ep ``world`` whose ranks compute the
    attention's gradients apart: a hook scales rank r's wq gradients by
    1 + r/1000, as a backward that sums in an order that changes from run
    to run differs in its rounding.  Rank 0 writes whether, after each
    step, every parameter and gradient the ep ranks replicate is bit for
    bit equal on every rank, and how far its wq gradients are from the
    mean of the ranks' scales times its own unscaled ones."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import moe
    from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, make_train_step, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    maybe_init_distributed("cpu")
    mesh = make_named_mesh({"dp": 1, "fsdp": 1, "tp": 1, "ep": world}, "cpu")
    cfg = moe.tiny()
    model = sharded_init(cfg, mesh, seed=3)
    unscaled = {}
    for i, blk in enumerate(model.layers):
        def scale(g, i=i):
            unscaled[i] = g.clone()
            return g * (1 + rank / 1000)
        blk.wq.weight.register_hook(scale)
    optimizer = adamw(model, 1e-3)
    step = make_train_step(cfg, model, optimizer, mesh=mesh)
    state = TrainState(model, optimizer)
    mean_scale = 1 + (world - 1) / 2000
    res = {"params_equal": [], "grads_equal": [], "wq_grad_rel_err": []}
    for i in range(2):
        batch = np.random.default_rng(i).integers(0, cfg.vocab_size,
                                                  (2, 17))
        state, _ = step(state, batch)
        equal = {"params_equal": True, "grads_equal": True}
        for n, p in model.named_parameters():
            if n.rsplit(".", 1)[-1] in moe.EXPERT_BANKS:
                continue
            for key, t in (("params_equal", p.detach()),
                           ("grads_equal", p.grad)):
                copies = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(copies, t.contiguous())
                equal[key] &= all(torch.equal(c, copies[0])
                                  for c in copies[1:])
        for key, ok in equal.items():
            res[key].append(ok)
        res["wq_grad_rel_err"].append(max(
            float((blk.wq.weight.grad - mean_scale * unscaled[j]).norm()
                  / unscaled[j].norm())
            for j, blk in enumerate(model.layers)))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def vocab_tp_worker(rank, world, port, in_path, out_dir):
    """The vocab-split tied head on four gloo ranks: one step's loss and
    gathered gradients through the plain and the chunked head on dp 2 x
    tp 2 (``make_train_step``) and through ``forward_sp`` on sp 2 x tp 2
    (``make_sp_train_step``, ring and ulysses); the embedding's local
    shape and placements; the dp 2 x tp 2 state after its step saved,
    restored on fsdp 4 (tp 1) and resharded back onto dp 2 x tp 2, each
    stop's gathered values against the first.  Rank 0 writes the
    results."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import (
        make_mesh, make_sp_mesh)
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState, adamw, make_sp_train_step, make_train_step,
        reshard_state, restore_on_mesh, save_checkpoint, sharded_init)
    from pytorch_operator_tpu_torch.utils import maybe_init_distributed

    data = np.load(in_path)
    maybe_init_distributed("cpu")
    cfg = llama.tiny(**json.loads(str(data["cfg"])))
    tree = {"embed": data["embed"], "final_norm": data["final_norm"],
            "layers": {k[len("layers/"):]: data[k] for k in data.files
                       if k.startswith("layers/")}}
    batch = data["batch"]
    mesh22 = make_mesh(2, 1, 2, "cpu")
    out, res = {}, {}

    def state_on(mesh):
        model = llama.load_jax_params(sharded_init(cfg, mesh), tree)
        return TrainState(model, adamw(model))

    runs = [("plain", mesh22, False, None), ("chunked", mesh22, True, None),
            ("sp_ring", make_sp_mesh(1, 2, tp=2, device="cpu"), False,
             "ring"),
            ("sp_ulysses_chunked", make_sp_mesh(1, 2, tp=2, device="cpu"),
             True, "ulysses")]
    for name, mesh, chunked, impl in runs:
        state = state_on(mesh)
        kw = dict(mesh=mesh, chunked_ce=chunked, ce_chunk=6)
        step = (make_train_step(cfg, state.model, state.optimizer, **kw)
                if impl is None else make_sp_train_step(
                    cfg, state.model, state.optimizer, impl=impl, **kw))
        state, m = step(state, batch)
        res[name] = {"loss": m["loss"].item(),
                     "embed_local": list(state.model.embed.to_local().shape),
                     "embed_placements": [
                         str(p) for p in state.model.embed.placements]}
        for n, p in state.model.named_parameters():
            out[f"{name}/grad/{n}"] = _full(p.grad)
        if name == "plain":
            trained = state
    first = gathered_state(trained)
    ckpt = os.path.join(out_dir, "ckpt")
    save_checkpoint(trained, ckpt)
    tp1 = restore_on_mesh(ckpt, 1, state_on(make_mesh(1, 4, 1, "cpu")))
    res["tp1_embed_local"] = list(tp1.model.embed.to_local().shape)
    res["restored_at_tp1"] = _same_values(first, gathered_state(tp1))
    back = reshard_state(tp1, cfg, mesh22)
    res["resharded_to_tp2"] = _same_values(first, gathered_state(back))
    res["resharded_embed_local"] = list(back.model.embed.to_local().shape)
    if rank == 0:
        np.savez(os.path.join(out_dir, "grads.npz"), **out)
        with open(os.path.join(out_dir, "res.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _same_values(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
