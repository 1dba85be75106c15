"""Traffic kind ``train_ddp``: the program's data-parallel train step, one process per card.

The configuration's ``n_devices`` ranks run as ``torchrun`` would start them: this process is rank
0 on the first card, and it starts ranks 1 to n-1 on the others (spawned, with torchrun's
environment variables and, as torchrun sets them, one host thread each for torch's CPU operations)
once the kernels are built. Every rank takes the program's own path, as
``tasks.pretrain.run`` does: ``multihost.maybe_initialize_distributed`` (NCCL on the card, gloo on
the CPU), ``make_mesh``, ``parallelize``, ``build_optimizer`` over the parallel layout with its
global norm, and ``make_mae_train_step(..., parallel=...)``. Each rank keeps its rows
``[r b, (r + 1) b)`` of every global batch of the pool (``traffic.image_pool``, made from the
seed), and the step draws the masks of the whole batch and takes its rows.

Set-up drives the step through its first calls (``follow``), then a timed probe of a few calls,
after which rank 0 fixes the number of calls in the window and broadcasts it: every rank then
makes exactly that many, with no host synchronisation beyond what the program does. The window is
rank 0's time from a barrier to the synchronise and barrier after its last call; its units are
the clips of all ranks. ``memory_peak_bytes`` is the largest rank's peak. With ``--trace`` rank 0
profiles its span while the other ranks run the same calls. ``rank_gap`` is the largest
difference between a parameter on any rank and on rank 0 after the last call.

After the ranks have left, rank 0 alone frees the program and the plain reference follows the
same first calls on the whole global batches, from the same weights and mask seeds. One DDP
update of n ranks of b rows is one update over the n b rows with no accumulation.

A rank that raises, or dies, or finds jax or the JAX package loaded in its process once the window
has closed, or a run that outlasts its deadline, ends the run: the watchdog stops every rank and
exits with an error, so that a collective that waits for a dead peer never hangs the run.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import socket
import sys
import threading
import time
import traceback
import types

import torch

from perfbench.harness import checks, faults, trace, weights, yardstick
from perfbench.harness import traffic as traffic_gen
from perfbench.reference import train as ref_train
from perfbench.reference.lowp import FP8, Exact

# micro-batches per rank in the profiled span of a ``--trace 1`` run, and in the window's probe
SPAN_CALLS = 3
PROBE_CALLS = 3
# seconds the ranks may take beyond the window, from their start to their end; and the seconds a
# rank's death leaves the others before the run ends
DEADLINE_S = 240.0
WATCH_S = 0.5
EXIT_FAILED = 70
_TORCHRUN_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def world_size(cell) -> int:
    return int(cell.config["n_devices"])


def rank_rows(cell) -> int:
    """The rows of a global batch that each rank steps."""
    batch, world = int(cell.workload["traffic"]["batch"]), world_size(cell)
    if batch % world:
        raise ValueError(f"A global batch of {batch} does not split over {world} ranks.")
    return batch // world


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _set_env(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(device: torch.device) -> None:
    """Every rank's work issued so far is done, and every rank has got here."""
    import torch.distributed as dist

    _sync(device)
    flag = torch.ones(1, device=device)
    dist.all_reduce(flag)
    _sync(device)


def _all_max(value: float, device: torch.device) -> float:
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def build_program(cell, settings: dict, device: torch.device):
    """(model, step_fn, state, parallel) of this rank, on the program's distributed path."""
    from cinema_tpu_torch.config import from_dict
    from cinema_tpu_torch.factory import get_mae_model
    from cinema_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cinema_tpu_torch.train.optim import build_optimizer, get_n_accum_steps
    from cinema_tpu_torch.train.state import TrainState, make_mae_train_step

    cfg, seed = cell.config, cell.seed
    config = from_dict(cfg)
    mesh_cfg = cfg["mesh"]
    mesh = make_mesh(n_model=int(mesh_cfg["n_model"]), device_type=device.type)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = get_mae_model(config, dtype=dtype, device=device)
    model.load_state_dict(weights.make_weights(weights.on_meta("mae", cfg), seed, device), strict=True)
    par = parallelize(model, mesh, fsdp=bool(mesh_cfg["fsdp"]))
    t = config.train
    k = get_n_accum_steps(t.batch_size, t.batch_size_per_device, mesh.size(0))
    if k != settings["accum"]:
        raise ValueError(f"The program accumulates {k} micro-batches, the reference {settings['accum']}.")
    tx = build_optimizer(
        dict(zip(par.names, par.optimizer_params(model))), lr=t.lr, min_lr=t.min_lr,
        warmup_steps=settings["warmup"], max_n_steps=settings["max_steps"], betas=tuple(t.betas),
        weight_decay=t.weight_decay, clip_grad=t.clip_grad, accum_steps=k, global_norm=par.global_norm,
    )
    state = TrainState.create(model, tx)
    step_fn = make_mae_train_step(model, tx, t.enc_mask_ratio, seed=seed, parallel=par)
    return model, step_fn, state, par


def _first_gradient(state, metrics: dict, names: list, settings: dict) -> dict:
    """Per leaf, the norm of the first call's mean gradient as the optimizer got it, worked out from
    its first moment after one update (mu = (1 - b1) g c, c the clip factor of the global norm)."""
    b1 = settings["betas"][0]
    norm = float(metrics["grad_norm"])
    clip = min(1.0, settings["clip"] / max(norm, 1e-12))
    return {n: float(m.norm()) / ((1.0 - b1) * clip) for n, m in zip(names, state.opt_state.mu)}


def _rank(cell, rank: int, out: dict) -> None:
    """One rank's whole part: the program's set-up, the first calls, the window, the profiled span and
    ``rank_gap``. Rank 0 fills ``out``."""
    from cinema_tpu_torch.parallel import multihost

    import torch.distributed as dist

    w, cfg, seed, correct = cell.workload, cell.config, cell.seed, cell.workload["correct"]
    device = multihost.maybe_initialize_distributed(multiprocess=True, device=cell.device.type)
    rows = rank_rows(cell)
    full = traffic_gen.image_pool(w["traffic"], cfg, seed, device)
    own = slice(rank * rows, (rank + 1) * rows)
    pool = [{k: v[own].contiguous() for k, v in b.items()} for b in full]
    del full
    n_follow = int(correct["follow"])
    if n_follow > len(pool):
        raise ValueError("The calls the reference follows need distinct batches of the pool.")
    settings = ref_train.optimizer_settings(cfg, w["step"], len(pool), int(w["traffic"]["batch"]))
    model, step_fn, state, par = build_program(cell, settings, device)
    if cell.fault in faults.TRAIN:
        step_fn = faults.wrap_step(cell.fault, step_fn, model)
    elif cell.fault in faults.DDP:
        faults.plant_ddp(cell.fault, par, rank)
    names = list(par.names)

    # the first calls, which the reference follows; they build and warm every kernel of the step
    prog = {"loss": []}
    for i in range(n_follow):
        state, metrics = step_fn(state, pool[i])
        prog["loss"].append(metrics["loss"])
        if i == 0 and rank == 0:
            prog["grad"] = _first_gradient(state, metrics, names, settings)
    if rank == 0:
        prog["loss"] = [float(x) for x in prog["loss"]]
        start = weights.make_weights(weights.on_meta(w["step"], cfg), seed, device)
        # kept in host memory through the window, so that they add nothing to its peak
        with torch.no_grad():
            prog["change_t"] = {n: (p.detach() - start[n]).cpu() for n, p in model.named_parameters()}
        del start
        out["prog"] = prog

    # the probe: rank 0 times a few calls and fixes the window's number of calls for every rank
    i = n_follow
    _barrier(device)
    t0 = time.perf_counter()
    for _ in range(PROBE_CALLS):
        state, metrics = step_fn(state, pool[i % len(pool)])
        i += 1
    _barrier(device)
    per_call = (time.perf_counter() - t0) / PROBE_CALLS
    n_calls = torch.tensor([max(1, round(cell.seconds / per_call))], dtype=torch.int64, device=device)
    dist.broadcast(n_calls, src=0)
    n_calls = int(n_calls[0])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if rank == 0:
        cell.mark_setup_done()
    skipped = []
    _barrier(device)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state, metrics = step_fn(state, pool[i % len(pool)])
        skipped.append(metrics.get("skipped_nan", torch.zeros((), device=device)))
        i += 1
    _barrier(device)
    window_s = time.perf_counter() - t0
    peak = _all_max(torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0, device)
    n_failed = int(torch.stack(skipped).sum())

    span = gaps = None
    if cell.trace:
        def steps(n: int) -> int:
            nonlocal state, i
            for _ in range(n):
                state, _ = step_fn(state, pool[i % len(pool)])
                i += 1
            return n

        if rank == 0:
            span = trace.profile_span(lambda: steps(SPAN_CALLS))
            gaps = trace.profile_span(lambda: steps(1), host_ops=True)
        else:
            steps(SPAN_CALLS + 1)
        _barrier(device)

    # every rank's parameters against rank 0's, after the last call
    with torch.no_grad():
        mine = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
        first = mine.clone()
        dist.broadcast(first, src=0)
        rank_gap = _all_max(float((mine - first).abs().max()), device)
    del mine, first, model, step_fn, state, par, metrics, skipped, pool
    _barrier(device)
    dist.destroy_process_group()
    if rank == 0:
        out.update(n_calls=n_calls, window_s=window_s, peak=peak, n_failed=n_failed, span=span, gaps=gaps,
                   rank_gap=rank_gap)


def _rank_main(cell, rank: int, world: int, port: int, parent: int) -> None:
    """A spawned rank: its part, then an exit that skips the interpreter's teardown (a process group's
    destructor may wait on a peer). It leaves as soon as its parent, rank 0, is gone, and exits with an
    error where jax, flax or the JAX package is in its ``sys.modules`` once its window has closed, as
    ``run.py`` does for rank 0."""
    from perfbench.run import forbidden_modules

    def orphaned() -> None:
        while os.getppid() == parent:
            time.sleep(WATCH_S)
        os._exit(EXIT_FAILED)

    threading.Thread(target=orphaned, daemon=True).start()
    _set_env(rank, world, port)
    torch.set_num_threads(1)
    code = 0
    try:
        if cell.fault == faults.RANK_RAISES and rank == 1:
            raise RuntimeError("rank 1 raised, as the fault asks")
        if cell.fault == faults.RANK_LOADS_JAX and rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")
        _rank(cell, rank, {})
        _sync(torch.device("cuda", rank) if cell.device.type == "cuda" else cell.device)
        found = forbidden_modules()
        if found:
            print(f"rank {rank} loaded {', '.join(found)}: the benchmark must not run the JAX package.",
                  file=sys.stderr)
            code = EXIT_FAILED
    except BaseException:  # noqa: BLE001 - any failure of a rank ends the run
        traceback.print_exc()
        code = EXIT_FAILED
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


class _Watchdog:
    """Ends the run where a spawned rank exits with an error or the ranks outlast their deadline:
    stops every rank and exits this process with an error, whatever collective it waits in."""

    def __init__(self, procs: list, deadline_s: float) -> None:
        self.procs, self.deadline = procs, time.perf_counter() + deadline_s
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self) -> None:
        while not self.done.wait(WATCH_S):
            failed = [p for p in self.procs if p.exitcode not in (None, 0)]
            late = time.perf_counter() > self.deadline
            if failed or late:
                why = (f"rank(s) {', '.join(p.name for p in failed)} exited with an error" if failed
                       else "the ranks outlasted their deadline")
                print(f"train_ddp: {why}; stopping every rank.", file=sys.stderr, flush=True)
                _stop(self.procs)
                os._exit(EXIT_FAILED)

    def close(self) -> None:
        self.done.set()
        self.thread.join()


def _stop(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def _ranks(cell) -> dict:
    """Runs every rank, this process as rank 0; returns rank 0's readings."""
    world = world_size(cell)
    if cell.device.type == "cuda":
        from cinema_tpu_torch import build

        build.build()  # once, before the ranks load the kernels
    port = _free_port()
    saved = {k: os.environ.get(k) for k in _TORCHRUN_ENV}
    _set_env(0, world, port)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(cell, r, world, port, os.getpid()), name=str(r))
             for r in range(1, world)]
    for p in procs:
        p.start()
    watchdog = _Watchdog(procs, cell.seconds + DEADLINE_S)
    out: dict = {}
    try:
        _rank(cell, 0, out)
        for p in procs:
            p.join()
    finally:
        watchdog.close()
        _stop(procs)
        torch.set_num_threads(threads)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    failed = [p.name for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"rank(s) {', '.join(failed)} exited with an error.")
    return out


def run(cell) -> dict:
    w, cfg, seed = cell.workload, cell.config, cell.seed
    step, correct = w["step"], w["correct"]
    if step != "mae" or not cfg["mesh"].get("multiprocess"):
        raise ValueError("train_ddp runs the MAE step of a configuration with mesh.multiprocess set.")
    got = _ranks(cell)
    prog, device = got["prog"], cell.device
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    batch, rows, n_follow = int(w["traffic"]["batch"]), rank_rows(cell), int(correct["follow"])
    pool = traffic_gen.image_pool(w["traffic"], cfg, seed, device)[:n_follow]
    settings = ref_train.optimizer_settings(cfg, step, int(w["traffic"]["n_batches"]), batch)
    flop = yardstick.model_flop(cfg, step, rows, train=True)
    calls = yardstick.attention_calls(cfg, step, rows, train=True)
    start = weights.make_weights(weights.on_meta(step, cfg), seed, device)
    block = int(correct["ref_block"])
    reference = ref_train.follow(step, cfg, start, pool, seed, settings, Exact(), block)
    if cell.fault == faults.CONTROL:
        prog = ref_train.follow(step, cfg, start, pool, seed, settings, FP8(), block)
    prog["change_t"] = {n: t.to(device) for n, t in prog["change_t"].items()}
    numbers = checks.training_numbers(prog, reference)
    numbers["rank_gap"] = got["rank_gap"]
    return {
        "units": got["n_calls"] * batch, "window_s": got["window_s"], "attempted": got["n_calls"],
        "failed": got["n_failed"], "memory_peak_bytes": got["peak"], "chips": world_size(cell),
        "flop_per_unit": flop / rows, "span": got["span"], "gaps": got["gaps"], "span_attention_calls": calls,
        "numbers": numbers, "worst": checks.worst_leaves(prog, reference),
    }
