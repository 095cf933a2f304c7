"""Data parallelism over `torch.distributed`, one process per device.

Port of `pharmaforge_tpu/parallel/mesh.py`. The JAX package shards one
process's batch over a device mesh; PyTorch's idiom is a process per
device in a process group: NCCL between CUDA devices, gloo on the CPU
(and between processes that share one card, which NCCL refuses). Every
rank holds the whole model and optimizer, loads only its contiguous rows
of each global batch (`process_local_rows`) and sums what the global
batch needs across ranks (`all_reduce_sum`, `all_reduce_grads`); the
trainer and the sampler keep every random draw at the global batch shape,
so N ranks compute what one rank computes for the whole batch.

`spawn_local` starts N ranks on this host, as `torchrun` would, each with
a wall-clock limit; a rank that fails ends the others and raises. Without
a process group every function here is the single-process identity. The
JAX module's `pad_batch_to_multiple` is `data/batch.py`'s.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.data.batch import pad_batch_to_multiple

# seconds a collective (and the group's rendezvous) may wait before it
# fails the run instead of stalling it
COLLECTIVE_TIMEOUT_S = 600.0


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank `local_rank`: `cuda` without an index
    becomes `cuda:<local_rank>`; any other device is taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None,
                     timeout_s: float = COLLECTIVE_TIMEOUT_S
                     ) -> torch.device:
    """Join the process group and return this rank's device.

    `coordinator` ('host:port' of rank 0), `num_processes` and
    `process_id` are the train CLI's flags; each one not given comes from
    `torchrun`'s environment (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK),
    as the JAX package's auto-detection does. `device` (CUDA by default)
    without an index becomes cuda:LOCAL_RANK. `backend` defaults to NCCL
    on CUDA and gloo on the CPU. A rendezvous or collective that waits
    longer than `timeout_s` raises."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"distributed: no {', '.join(missing)} given and "
                         f"none in the environment (MASTER_ADDR, "
                         f"WORLD_SIZE, RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"distributed: process_id {process_id} outside "
                         f"0..{num_processes - 1}")
    device = rank_device(resolve_device(device),
                         int(env.get("LOCAL_RANK", process_id)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def world() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one process that writes files and prints."""
    return rank() == 0


def process_local_rows(n_rows_global: int) -> Tuple[int, int]:
    """(start, stop) of this rank's contiguous rows of a global batch
    (JAX mesh.py:95-117); raises when the ranks do not divide it."""
    n = world()
    if n_rows_global % n:
        raise ValueError(f"global batch {n_rows_global} not divisible by "
                         f"{n} ranks")
    per = n_rows_global // n
    return rank() * per, (rank() + 1) * per


def local_batch(batch) -> Tuple[Any, Optional[Tuple[int, int]]]:
    """A global batch padded to a multiple of the ranks, cut to this
    rank's rows, with (start, global rows) for `loss`'s `rows`; without a
    process group, the batch as it is and None."""
    if not dist.is_initialized():
        return batch, None
    batch, _ = pad_batch_to_multiple(batch, world())
    start, stop = process_local_rows(batch.batch_size)
    return type(batch)(**{f.name: getattr(batch, f.name)[start:stop]
                          for f in dataclasses.fields(batch)}), \
        (start, batch.batch_size)


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the ranks in place (a no-op without a process
    group; with one, also at world size 1) and return it."""
    if dist.is_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the gradients of `params` over the ranks, in one collective
    over one flat buffer. Parameters without a gradient stay so (every
    rank runs the same model, so the set is the same on each)."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, in place."""
    if not dist.is_initialized():
        return
    tensors = list(module.state_dict().values())
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    dist.broadcast(flat, src=0)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel()
                                                for t in tensors])):
            t.copy_(part.view_as(t).to(t.dtype))


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order ([obj] without a group)."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn: Callable, args: tuple, local_rank: int, n: int,
                port: int, threads: int, results) -> None:
    """Body of a spawned rank: torchrun's environment, `fn(*args)`, its
    result (or traceback) to the parent, the group torn down."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n), RANK=str(local_rank),
                      LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(n))
    torch.set_num_threads(threads)
    try:
        out = fn(*args)
    except BaseException:
        results.put((local_rank, False, traceback.format_exc()))
    else:
        # plain pickle bytes: a queued tensor would otherwise be shared
        # through a file descriptor that dies with this process
        results.put((local_rank, True, pickle.dumps(out)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(n: int, fn: Callable, *args,
                timeout_s: float = 3600.0) -> List[Any]:
    """Run `fn(*args)` in `n` new processes, ranks 0..n-1 of one group on
    this host, and return their results in rank order.

    Each process gets `torchrun`'s environment (MASTER_ADDR, MASTER_PORT
    of a free local port, WORLD_SIZE, RANK, LOCAL_RANK), so `fn` joins
    the group with `init_distributed()`, and 1/n of this process's CPU
    threads. `fn`, `args` and the results must pickle. A rank that raises
    or dies ends the others and raises RuntimeError with its traceback;
    ranks still running after `timeout_s` seconds are ended and
    TimeoutError raised."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    threads = max(1, torch.get_num_threads() // n)
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, args, r, n, port, threads, results))
             for r in range(n)]
    for p in procs:
        p.start()
    done: dict = {}
    deadline = time.monotonic() + timeout_s

    def take(block: bool) -> None:
        try:
            r, ok, val = results.get(timeout=0.2) if block \
                else results.get_nowait()
        except queue_mod.Empty:
            return
        if not ok:
            raise RuntimeError(f"rank {r} of {n} failed:\n{val}")
        done[r] = pickle.loads(val)

    try:
        while len(done) < n:
            take(block=True)
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in done and p.exitcode not in (None, 0)]
            if dead:
                take(block=False)
                raise RuntimeError(f"rank {dead[0][0]} of {n} exited with "
                                   f"code {dead[0][1]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n - len(done)} of {n} ranks still "
                                   f"running after {timeout_s} s")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [done[r] for r in range(n)]
