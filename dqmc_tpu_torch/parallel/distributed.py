"""Walkers across processes: the process group and its few collectives.

PyTorch counterpart of ``dqmc_tpu/parallel/distributed.py`` and of the
helpers ``_maybe_init_distributed``, ``_rank0_log`` and ``global_stats`` of
``dqmc_tpu/run.py`` (the reference's ``mpirun -np N`` with MPI_Init and
MPI_Reduce, main.cpp:20-28, 186-187).

Every process runs its own walkers (or parallel-tempering replicas), a
contiguous slice of the run's, on its own devices; walker w's random
stream depends only on (seed, global index w), so the chains do not
depend on how the walkers are spread.  Each process writes
``data_<rank_offset + w>`` for its walkers, the reference's per-rank file
naming.

Every collective runs through gloo on small CPU tensors, whatever device
the walkers live on: the traffic is a few scalars per bin (and, with
parallel tempering, the fields, signs and actions of each attempt), and
NCCL refuses two ranks on one GPU, the only layout a one-GPU machine can
run.  The reductions gather the per-walker values of every process in
walker order and reduce them as an unsplit run does, so a run's summary
and its decisions do not depend on the split either.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# a collective that waits this long for a peer fails the run
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Form the process group (a no-op for one process, as in JAX).

    ``coordinator_address`` (host:port) gives ``tcp://`` rendezvous;
    without it the group forms through ``env://`` (MASTER_ADDR,
    MASTER_PORT, and RANK when ``process_id`` is not given).  A collective
    that waits longer than ``timeout_s`` for a peer raises, so a dead peer
    ends the run instead of hanging it.  A group formed already (a second
    run in one process) is kept when its size agrees.  An address without
    ``num_processes`` takes WORLD_SIZE from the environment."""
    if coordinator_address and not num_processes:
        if "WORLD_SIZE" not in os.environ:
            raise ValueError("[distributed] coordinator_address needs "
                             "num_processes (or WORLD_SIZE in the "
                             "environment)")
        num_processes = int(os.environ["WORLD_SIZE"])
    nproc = int(num_processes or 1)
    if nproc <= 1:
        return
    if dist.is_initialized():
        if dist.get_world_size() != nproc:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"processes exists; [distributed] asks for "
                             f"{nproc}")
        return
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("[distributed] num_processes > 1 needs "
                             "process_id (or RANK in the environment)")
        process_id = int(os.environ["RANK"])
    if not 0 <= process_id < nproc:
        raise ValueError(f"[distributed] process_id {process_id} outside "
                         f"0..{nproc - 1}")
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group("gloo", init_method=init, world_size=nproc,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(shutdown_distributed)


def shutdown_distributed() -> None:
    """Destroy the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank_offset(walkers_per_device: int,
                      n_local_devices: int = 1) -> int:
    """First output-file index owned by this process: process rank x
    local devices x walkers per device (JAX distributed.py:47-52, the
    reference's per-rank naming, measurementh5.h:294)."""
    return process_index() * n_local_devices * walkers_per_device


def rank0_log(verbose: bool) -> Callable:
    """print on process 0 only (utility.h:278-288); silent unless
    ``verbose``."""
    if not verbose or process_index() != 0:
        return lambda *a, **k: None
    return print


def all_gather_walkers(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's ``x`` (a CPU tensor whose ``dim`` runs over its
    walkers, the same shape on every process) concatenated along ``dim``
    in process order: the run's walkers in global order."""
    x = x.detach().cpu().contiguous()
    if process_count() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


def all_max(x: float) -> float:
    """The largest ``x`` over the processes."""
    if process_count() == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def all_agree(x: int) -> bool:
    """Whether every process holds the same integer ``x``."""
    if process_count() == 1:
        return True
    t = torch.tensor([int(x), -int(x)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0]) == -int(t[1])


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process ``src``'s ``x`` (a CPU tensor of the same shape and dtype on
    every process)."""
    x = x.detach().cpu().contiguous().clone()
    if process_count() > 1:
        dist.broadcast(x, src=src)
    return x


_STATS = ("acc_sum", "err_max", "err_sum", "err_count")


def walker_values(chunks: Sequence, name: str) -> torch.Tensor:
    """The leaf ``name`` (walker axis first) of every walker of the run,
    in global order, as one float64 CPU tensor: the process's chunks
    concatenated, then every process's gathered."""
    return all_gather_walkers(torch.cat([
        getattr(s, name).detach().to("cpu", torch.float64)
        for s in chunks]))


def global_stats(chunks: Sequence) -> dict:
    """The run statistics over every walker of every process (JAX
    run.py:222-236, the MPI_Reduce of main.cpp:186-187): the walkers'
    values gathered in global order and reduced in float64, so every
    process reads the same numbers and an unsplit run reads them too."""
    local = torch.stack([torch.cat([
        getattr(s, n).detach().to("cpu", torch.float64) for s in chunks])
        for n in _STATS])
    acc, emax, esum, ecnt = all_gather_walkers(local, dim=1)
    return dict(acc_sum_mean=float(acc.mean()), err_max=float(emax.max()),
                err_sum=float(esum.sum()), err_count=float(ecnt.sum()))
